"""Nemotron-4 15B — dense, GQA 48/8, squared-ReLU MLP, LayerNorm.

[arXiv:2402.16819]
"""
from repro_torch.config import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    source="arXiv:2402.16819",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=256000,
    act="relu2",
    norm="layernorm",
    attn=AttnConfig(rope_theta=10000.0),
)
