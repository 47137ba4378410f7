"""Switch-Large-128 (paper evaluation model) — T5-large MoE, 128 experts top-1.

[arXiv:2101.03961] 24 layers, d 1024, d_ff 4096; MoE every 2nd layer.
"""
from repro_torch.config import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="switch-large-128",
    family="moe",
    source="arXiv:2101.03961",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=32128,
    act="gelu",
    norm="rmsnorm",
    attn=AttnConfig(),
    moe=MoEConfig(n_experts=128, top_k=1, d_expert=4096,
                  moe_layer_period=2, moe_layer_offset=1),
)
