"""Qwen3-MoE 235B-A22B — 94L, 128 experts top-8, GQA 64/4, qk-norm.

[hf:Qwen/Qwen3-30B-A3B family scaled per assignment]
"""
from repro_torch.config import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,                     # expert hidden dim (all FFNs are MoE)
    vocab=151936,
    act="swiglu",
    attn=AttnConfig(qk_norm=True, rope_theta=1_000_000.0),
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536,
                  router_norm_topk=True),
)
