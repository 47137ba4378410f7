"""Jamba-1.5-Large 398B — hybrid Mamba+attention 1:7, MoE 16e top-2.

[arXiv:2403.19887] 72 layers; one attention layer per 8 (offset 4 as in the
released config), MoE every 2nd layer; Mamba d_state 16, conv 4, expand 2.
"""
from repro_torch.config import ArchConfig, AttnConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    act="swiglu",
    attn=AttnConfig(),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576,
                  moe_layer_period=2, moe_layer_offset=1),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    attn_layer_period=8,
    attn_layer_offset=4,
)
