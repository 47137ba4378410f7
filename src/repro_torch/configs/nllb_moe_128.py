"""NLLB-MoE-128 (paper evaluation model) — translation MoE, 128 experts top-2.

[arXiv:2207.04672] Decoder-only simplification of the NLLB backbone; MoE every
4th layer as in the released checkpoint.
"""
from repro_torch.config import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="nllb-moe-128",
    family="moe",
    source="arXiv:2207.04672",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab=256206,
    act="gelu",
    norm="layernorm",
    attn=AttnConfig(qkv_bias=True),
    moe=MoEConfig(n_experts=128, top_k=2, d_expert=8192,
                  moe_layer_period=4, moe_layer_offset=3),
)
