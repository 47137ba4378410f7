"""Single-token GQA decode over a head_dim slice of the cache on the GPU:
wrappers of ``csrc/decode_scores.cu`` (B3-qk) and ``csrc/decode_values.cu``
(B3-pv), the two halves of B3 that a head_dim-sharded cache decodes
through.

A cache whose KV heads do not divide the model axis is sharded on head_dim
(``launch/sharding.py::cache_shardings``). B3 needs whole heads, so a
placed decode step over such a cache runs, on each rank, B3-qk over its
slice (partial scores), an all-reduce of the scores over the model axis,
then B3-pv over its V slice (``models/attention.py::_attend``): the
partitioning GSPMD gives the reference's decode there, with no gather of
the cache. Neither half has a Pallas kernel of its own: together they
replace the Pallas ``repro.kernels.flash_decode.flash_decode`` on that
path.

Both take CUDA tensors only; the CPU path is ``ref.decode_scores_ref`` /
``ref.decode_values_ref`` (dispatch lives in ``ops``). ``scores_launches``
and ``values_launches`` count the calls that launched each kernel (one per
call, although a B3-pv call that splits T across blocks runs as two
launches: the splits, then their combine).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lengths

# B3-pv's tile, as csrc/decode_values.cu states it: TILE is kWarps * kStep
# there (the launch refuses a split_len that is not a multiple of it) and
# HEADS is kHeads
TILE = 128           # positions a B3-pv block takes per step (4 warps x 32)
HEADS = 16           # query heads per B3-pv block (the tensor-core tile's M)
BLOCKS_PER_SM = 8    # blocks of work per SM that a split aims for
HEAD_DIMS = (4, 8, 16, 32, 64, 128)   # head_dim slices the kernels take

scores_launches = 0
values_launches = 0


def splits(B: int, Hkv: int, rep: int, S: int, n_sm: int):
    """How B3-pv cuts S across blocks: -> (splits, split_len).

    The lengths live on the device, so the split follows from S and the
    grid alone: a full cache of B * Hkv * ceil(rep / HEADS) blocks is cut
    into runs of whole tiles until there are about ``BLOCKS_PER_SM`` blocks
    of work per SM (so at most ``BLOCKS_PER_SM * n_sm`` splits, within
    what the combine takes); with half the rows short, about half of them
    hold positions. One split covers all of S."""
    blocks = B * Hkv * math.ceil(rep / HEADS)
    tiles = math.ceil(S / TILE)
    per = math.ceil(tiles * blocks / (BLOCKS_PER_SM * n_sm))
    return math.ceil(tiles / per), per * TILE


def _check_heads(H: int, Hkv: int):
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")


def _check_hd(name: str, hd: int):
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name} kernel takes a head_dim slice in "
                         f"{HEAD_DIMS}, got {hd}")


def decode_scores(q, k, cache_len, scale: float):
    """B3-qk. q: (B, H, hd_l); k: (B, S, Hkv, hd_l), one head_dim slice of
    each; cache_len: int or int tensor, scalar or (B,); ``scale``: 1/sqrt
    of the whole head_dim. -> the partial scores (B, H, S) fp32, 0 at
    positions past each row's length."""
    global scores_launches
    if q.device.type != "cuda":
        raise ValueError("decode_scores kernel needs CUDA tensors; the CPU "
                         "path is kernels.ref.decode_scores_ref")
    build.check_no_grad("decode_scores", q, k)
    if q.dtype not in build.DTYPES:
        raise TypeError(f"decode_scores supports fp32/bf16, got {q.dtype}")
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    _check_heads(H, Hkv)
    _check_hd("decode_scores", hd)
    dev, dt = q.device, q.dtype
    build.check_tensor("q", q, (B, H, hd), dt, dev)
    build.check_tensor("k", k, (B, S, Hkv, hd), dt, dev)
    q, k = build.aligned16(q), build.aligned16(k)
    lens = lengths(cache_len, B, dev)
    scores = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    fn = build.load("decode_scores")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), lens.data_ptr(),
                 scores.data_ptr(), B, S, Hkv, H // Hkv, hd, float(scale),
                 build.DTYPES[dt], stream)
    build.check("decode_scores", err)
    scores_launches += 1
    return scores


def decode_values(scores, v, cache_len, softcap: float = 0.0, *,
                  return_lse: bool = False):
    """B3-pv. scores: (B, H, S) fp32, summed over the head_dim slices;
    v: (B, S, Hkv, hd_l), one head_dim slice; cache_len as in
    ``decode_scores``; ``softcap``: logit cap (0 = none) of the summed
    scores. -> the output's slice (B, H, hd_l) in v's dtype; with
    ``return_lse`` also each row's fp32 log-sum-exp (B, H). A row with no
    valid position gives out 0 (and lse -inf)."""
    global values_launches
    if v.device.type != "cuda":
        raise ValueError("decode_values kernel needs CUDA tensors; the CPU "
                         "path is kernels.ref.decode_values_ref")
    build.check_no_grad("decode_values", scores, v)
    if v.dtype not in build.DTYPES:
        raise TypeError(f"decode_values supports fp32/bf16, got {v.dtype}")
    B, H, S = scores.shape
    Hkv, hd = v.shape[2], v.shape[3]
    _check_heads(H, Hkv)
    _check_hd("decode_values", hd)
    dev, dt = v.device, v.dtype
    build.check_tensor("scores", scores, (B, H, S), torch.float32, dev)
    build.check_tensor("v", v, (B, S, Hkv, hd), dt, dev)
    scores, v = build.aligned16(scores), build.aligned16(v)
    softcap = float(softcap)
    if not softcap >= 0.0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    lens = lengths(cache_len, B, dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, split_len = splits(B, Hkv, H // Hkv, S, n_sm)
    part = (torch.empty((B * H * n_split * (hd + 2),), dtype=torch.float32,
                        device=dev) if n_split > 1 else None)
    out = torch.empty((B, H, hd), dtype=dt, device=dev)
    lse = (torch.empty((B, H), dtype=torch.float32, device=dev)
           if return_lse else None)
    fn = build.load("decode_values")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(scores.data_ptr(), v.data_ptr(), lens.data_ptr(),
                 out.data_ptr(), part.data_ptr() if part is not None else None,
                 lse.data_ptr() if lse is not None else None, B, S, Hkv,
                 H // Hkv, hd, n_split, split_len, softcap, build.DTYPES[dt],
                 stream)
    build.check("decode_values", err)
    values_launches += 1
    return (out, lse) if return_lse else out
