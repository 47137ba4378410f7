"""Roofline of a dry-run record on the H100.

Three terms per (arch × shape × mesh), in seconds, from the dry run's
traced counts (``launch/dryrun.py``):

    compute    = dot FLOPs / (devices × 989e12 FLOP/s, bf16 dense)
    memory     = bytes accessed / (devices × 3.35e12 B/s of HBM)
    collective = one device's collective bytes / 450e9 B/s of NVLink

The dot FLOPs and bytes are counted over the whole step, so those terms
are the time of an even split over ``n_devices`` cards. The collective
bytes are one device's, from the placed step over a fake group of the
mesh's size (the reference's ``collectives`` format); the link rate is
the H100 SXM's NVLink 4 datasheet figure (``kernels/bounds.py``), not the
TPU's ICI. A record whose step was not placed (``collectives`` None) has
no collective term. ``_attn_context_flops``, ``model_flops_for`` and
``load_records`` are the reference's own: a step's model FLOPs follow from
its config and shape alone, whatever code computes the step.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

from repro_torch.kernels import bounds as _bounds

# H100 SXM: bf16 dense tensor cores, HBM3 (the kernels' bounds' peaks)
PEAK_FLOPS = _bounds.PEAK_FLOPS["torch.bfloat16"]
HBM_BW = _bounds.HBM_BYTES_PER_S
LINK_BW = _bounds.NVLINK_BYTES_PER_S


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    dominant: str
    flops: float
    bytes_accessed: float
    collective_bytes_per_dev: Optional[float]
    model_flops: float
    useful_ratio: float


def analyze(rec: dict, model_flops: float) -> Roofline:
    """rec: one dry-run record (``status == "ok"``). model_flops: from
    ``model_flops_for``. The dominant term is the largest of compute,
    memory and (when the record has ``collectives``) collective;
    ``useful_ratio`` is model FLOPs over traced dot FLOPs."""
    n_dev = rec["n_devices"]
    cc = rec["cost_corrected"]
    flops, byts = cc["dot_flops"], cc["bytes_accessed"]
    compute_s = flops / (n_dev * PEAK_FLOPS)
    memory_s = byts / (n_dev * HBM_BW)
    terms = {"compute": compute_s, "memory": memory_s}
    coll = collective_s = None
    if rec.get("collectives") is not None:
        coll = sum(v["bytes"] for v in rec["collectives"].values())
        collective_s = terms["collective"] = coll / LINK_BW
    dominant = max(terms, key=terms.get)
    useful = model_flops / flops if flops else 0.0
    return Roofline(compute_s, memory_s, collective_s, dominant, flops, byts,
                    coll, model_flops, useful)


def _attn_context_flops(cfg, S: int, B: int, kind: str) -> float:
    """Attention O(S·ctx) term (dominant at 32k+ contexts; absent from the
    6·N·D rule of thumb). 4·ctx·H·hd per token per attention layer
    (QK^T + PV), window-capped for local layers; MLA uses the latent width.
    """
    total = 0.0
    for i in range(cfg.n_layers):
        if cfg.block_kind(i) != "attn":
            continue
        if cfg.attn.mla is not None:
            m = cfg.attn.mla
            width = cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                                   + m.v_head_dim) / 2
        else:
            width = cfg.n_heads * cfg.head_dim_
        win = cfg.attn.sliding_window if cfg.is_local_attn_layer(i) else 0
        if kind == "decode":
            ctx = min(S, win) if win else S
            tokens = B                       # one new token per sequence
        else:
            ctx = min(S, win) / 2 if win else S / 2   # causal average
            tokens = B * S
        total += 4.0 * tokens * ctx * width
    if cfg.is_encoder_decoder and kind != "decode":
        Se = cfg.encoder_seq_len
        width = cfg.n_heads * cfg.head_dim_
        total += cfg.n_encoder_layers * 4.0 * B * Se * Se * width  # enc self
        total += cfg.n_layers * 4.0 * B * S * Se * width           # cross
    return total * (3.0 if kind == "train" else 1.0)


def model_flops_for(cfg, shape, kind: str) -> float:
    """Param term (6·N_active·D train / 2·N_active·D inference) plus the
    attention context term (see _attn_context_flops)."""
    n_active = cfg.active_param_count()
    S, B = shape.seq_len, shape.global_batch
    if kind == "train":
        base = 6.0 * n_active * B * S
    elif kind == "prefill":
        base = 2.0 * n_active * B * S
    else:
        base = 2.0 * n_active * B
    return base + _attn_context_flops(cfg, S, B, kind)


def load_records(dirpath: str):
    recs = []
    for fn in sorted(os.listdir(dirpath)):
        if fn.endswith(".json"):
            with open(os.path.join(dirpath, fn)) as f:
                recs.append(json.load(f))
    return recs
