"""Qwen3-1.7B — dense, qk-norm, GQA 16/8, SwiGLU 6144. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.config import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab=151936,
    act="swiglu",
    tie_embeddings=True,
    attn=AttnConfig(qk_norm=True, rope_theta=1_000_000.0),
)
