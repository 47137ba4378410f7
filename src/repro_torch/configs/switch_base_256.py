"""Switch-Base-256 (paper evaluation model) — T5-base MoE, 256 experts top-1.

[arXiv:2101.03961] Same backbone as switch-base-128 with 256 experts; the
paper uses it to stress prediction accuracy vs expert count (Fig 4, Fig 9).
"""
from repro_torch.config import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="switch-base-256",
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
    moe=MoEConfig(n_experts=256, top_k=1, d_expert=3072,
                  moe_layer_period=2, moe_layer_offset=1),
)
