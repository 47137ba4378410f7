"""Gemma-2 2B — alternating local(4096)/global attention, logit softcaps.

[arXiv:2408.00118] GQA 8/4, head_dim 256, GeGLU 9216, post-block norms,
attention softcap 50, final logit softcap 30, embeddings scaled by sqrt(d).
"""
from repro_torch.config import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    source="arXiv:2408.00118",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    act="geglu",
    post_block_norm=True,
    embed_scale=True,
    final_logit_softcap=30.0,
    tie_embeddings=True,
    attn=AttnConfig(logit_softcap=50.0, sliding_window=4096,
                    local_global_period=2),
)
