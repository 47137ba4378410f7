"""Whisper-small — 12+12 enc-dec, MHA 12 heads, GELU, conv frontend stub.

[arXiv:2212.04356] The mel+conv frontend is a stub: input_specs() provides
precomputed frame embeddings (B, 1500, 768).
"""
from repro_torch.config import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    attn=AttnConfig(qkv_bias=True, use_rope=False),
    is_encoder_decoder=True,
    n_encoder_layers=12,
    encoder_seq_len=1500,
    frontend="audio",
    max_seq_len=32768,   # assigned backbone shapes; real Whisper caps at 448
)
