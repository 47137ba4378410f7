"""Qwen2-VL 72B — language backbone with M-RoPE; vision encoder is a stub.

[arXiv:2409.12191] GQA 64/8, QKV bias, SwiGLU 29568; M-RoPE splits each
half-rotary dim into (t, h, w) = (16, 24, 24) sections. input_specs() provides
pre-projected patch/text embeddings plus 3D position ids.
"""
from repro_torch.config import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    act="swiglu",
    attn=AttnConfig(qkv_bias=True, rope_theta=1_000_000.0,
                    mrope_sections=(16, 24, 24)),
    frontend="vision",
)
