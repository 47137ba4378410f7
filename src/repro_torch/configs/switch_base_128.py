"""Switch-Base-128 (paper evaluation model) — T5-base MoE, 128 experts top-1.

[arXiv:2101.03961] Decoder-only simplification of the T5 backbone used for the
serving benchmarks (the offload engine only depends on the routed-MoE shape).
MoE every 2nd layer, as in Switch.
"""
from repro_torch.config import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="switch-base-128",
    family="moe",
    source="arXiv:2101.03961",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=32128,
    act="gelu",
    norm="rmsnorm",
    attn=AttnConfig(),
    moe=MoEConfig(n_experts=128, top_k=1, d_expert=3072,
                  moe_layer_period=2, moe_layer_offset=1),
)
