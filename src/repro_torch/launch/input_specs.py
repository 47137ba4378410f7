"""Meta-tensor stand-ins for every model input, with the reference's
shapes and dtypes (``launch/input_specs.py``): shapes without data, so a
full-size step traces with no memory. ``LONG_CONTEXT_OK``,
``supports_shape`` and ``skip_reason`` are the reference's own.
"""
from __future__ import annotations

import torch

from repro_torch.config import ArchConfig, InputShape
from repro_torch.models import Model

# archs that may run the 524k decode shape (sub-quadratic decode state);
# gemma2 runs it in the windowed variant (DESIGN.md §5)
LONG_CONTEXT_OK = {"rwkv6-7b", "jamba-1.5-large-398b", "gemma2-2b"}


def supports_shape(cfg: ArchConfig, shape: InputShape) -> bool:
    if shape.name == "long_500k":
        return cfg.name in LONG_CONTEXT_OK
    return True


def skip_reason(cfg: ArchConfig, shape: InputShape) -> str:
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_OK:
        return ("full-attention KV at 524k is quadratic-cost prefill / "
                "unbounded KV decode; skipped per DESIGN.md §5")
    return ""


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def decode_window(cfg: ArchConfig, shape: InputShape) -> int:
    """The reference's windowed variant: long_500k decodes a sliding-window
    model over rings of its window."""
    if shape.name == "long_500k" and cfg.attn.sliding_window:
        return cfg.attn.sliding_window
    return 0


def train_inputs(cfg: ArchConfig, shape: InputShape) -> dict:
    """{tokens} (+ modality stubs) for a train/prefill step: tokens,
    labels and positions int32, embeddings bf16."""
    B, S = shape.global_batch, shape.seq_len
    batch = {}
    if cfg.frontend == "vision":
        batch["embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
        batch["positions"] = _meta((3, B, S), torch.int32)
        if shape.kind == "train":
            batch["labels"] = _meta((B, S), torch.int32)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = _meta((B, cfg.encoder_seq_len, cfg.d_model),
                                    torch.bfloat16)
    return batch


def decode_inputs(cfg: ArchConfig, shape: InputShape, model=None):
    """(cache, token) stand-ins for ``serve_step``: the cache of
    ``Model.init_cache(B, S, decode_window)`` on meta; the token (B,)
    int32, or (B, 1, d) bf16 embeddings under a vision frontend."""
    model = model or Model(cfg, device="meta")
    B, S = shape.global_batch, shape.seq_len
    cache = model.init_cache(B, S, decode_window(cfg, shape))
    if cfg.frontend == "vision":
        token = _meta((B, 1, cfg.d_model), torch.bfloat16)
    else:
        token = _meta((B,), torch.int32)
    return cache, token
