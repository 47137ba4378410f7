"""Qwen2-1.5B — dense, GQA 12/2, QKV bias, SwiGLU 8960. [arXiv:2407.10671]"""
from repro_torch.config import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    source="arXiv:2407.10671",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    act="swiglu",
    tie_embeddings=True,
    attn=AttnConfig(qkv_bias=True, rope_theta=1_000_000.0),
)
