"""Single-token GQA decode attention on the GPU: wrapper of
``csrc/flash_decode.cu``.

Replaces the Pallas ``repro.kernels.flash_decode.flash_decode``. Takes CUDA
tensors only; the CPU path is ``ref.flash_decode_ref`` (dispatch lives in
``ops``). ``launches`` counts calls that launched the kernel (one per call,
although a call that splits S across blocks runs as two launches: the
splits, then their combine).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lengths

HEAD_DIMS = (64, 128, 256)
TILE = 64            # positions a block takes per step (4 warps x 16)
HEADS = 16           # query heads per block (the tensor-core tile's M)
BLOCKS_PER_SM = 4    # blocks of work per SM that a split aims for

launches = 0


def splits(B: int, Hkv: int, rep: int, S: int, n_sm: int):
    """How S is split across blocks: -> (splits, split_len).

    The lengths live on the device, so the split follows from S and the
    grid alone: a full cache of B * Hkv * ceil(rep / HEADS) blocks is cut
    into runs of whole tiles until there are about ``BLOCKS_PER_SM`` blocks
    of work per SM. Rows shorter than S take fewer splits (the rest exit at
    once). One split covers all of S."""
    blocks = B * Hkv * math.ceil(rep / HEADS)
    tiles = math.ceil(S / TILE)
    per = max(1, math.ceil(tiles * blocks / (BLOCKS_PER_SM * n_sm)))
    return math.ceil(tiles / per), per * TILE


def flash_decode(q, k, v, cache_len, softcap: float = 0.0, *,
                 return_lse: bool = False):
    """q: (B, H, hd); k/v: (B, S, Hkv, hd); cache_len: int or int tensor,
    scalar or (B,) per-slot valid lengths; hd in ``HEAD_DIMS``;
    ``softcap``: logit cap (0 = none), ``cap * tanh(s / cap)`` of the
    scaled scores. -> (B, H, hd) in q's dtype; with ``return_lse`` also
    each row's fp32 log-sum-exp of its scaled, capped scores (B, H), and a
    row with no valid position gives out 0 and lse -inf (without it, the
    uniform softmax of ``ref.flash_decode_ref``)."""
    global launches
    if q.device.type != "cuda":
        raise ValueError("flash_decode kernel needs CUDA tensors; the CPU "
                         "path is kernels.ref.flash_decode_ref")
    build.check_no_grad("flash_decode", q, k, v)
    if q.dtype not in build.DTYPES:
        raise TypeError(f"flash_decode supports fp32/bf16, got {q.dtype}")
    B, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    dev, dt = q.device, q.dtype
    build.check_tensor("q", q, (B, H, hd), dt, dev)
    build.check_tensor("k", k, (B, S, Hkv, hd), dt, dev)
    build.check_tensor("v", v, (B, S, Hkv, hd), dt, dev)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode kernel takes hd in {HEAD_DIMS}, "
                         f"got {hd}")
    softcap = float(softcap)
    if not softcap >= 0.0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    lens = lengths(cache_len, B, dev)
    rep = H // Hkv
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, split_len = splits(B, Hkv, rep, S, n_sm)
    # fp32 (acc, m, l) partials of each split, combined by a second launch
    part = (torch.empty((B * H * n_split * (hd + 2),), dtype=torch.float32,
                        device=dev) if n_split > 1 else None)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=dev)
           if return_lse else None)
    fn = build.load("flash_decode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                 out.data_ptr(), part.data_ptr() if part is not None else None,
                 lse.data_ptr() if lse is not None else None, B, S, Hkv,
                 rep, hd, n_split, split_len, hd ** -0.5,
                 softcap, build.DTYPES[dt], stream)
    build.check("flash_decode", err)
    launches += 1
    return (out, lse) if return_lse else out
