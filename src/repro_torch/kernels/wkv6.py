"""RWKV6 recurrence on the GPU: wrapper of ``csrc/wkv6.cu``.

Replaces the Pallas ``repro.kernels.wkv6.wkv6`` (B4). Takes CUDA tensors
only; the CPU path is ``ref.wkv6_ref`` (dispatch lives in ``ops``). There is
no ``chunk`` argument: one launch carries the state over any T >= 1.
Each (b, h) row's hd x hd state is split over blocks by columns and over
warps by rows (``plan``). ``launches`` counts calls that launched the
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64)
COLS = 32         # state columns a block takes: a warp's lanes ...
FEW_COLS = 16     # ... or half, for more blocks
ROWS = 8          # state rows a thread keeps in registers: a short chain ...
MANY_ROWS = 16    # ... or twice that, for fewer partial sums
BLOCKS_PER_SM = 2

launches = 0


def plan(BH: int, hd: int, n_sm: int):
    """How each row's (hd, hd) state is split: -> (row_groups, cols).

    A block takes ``cols`` state columns and all hd rows of them, in
    ``row_groups`` groups, one thread per (group, column): a thread keeps
    ``hd // row_groups`` state elements in registers, and a step is a chain
    of that many updates; the grid has ``BH * hd // cols`` blocks. When
    blocks of COLS columns already give every SM BLOCKS_PER_SM of them,
    threads take MANY_ROWS rows (fewer partial sums of o); otherwise ROWS
    rows and FEW_COLS columns (shorter chains, more blocks)."""
    cols = min(COLS, hd)
    if BH * (hd // cols) >= BLOCKS_PER_SM * n_sm:
        return hd // MANY_ROWS, cols
    return hd // ROWS, min(FEW_COLS, hd)


def wkv6(r, k, v, w, u, s0):
    """r/k/v: (BH, T, hd) fp32 or bf16; w: (BH, T, hd) fp32 or r's dtype;
    u: (BH, hd) and s0: (BH, hd, hd) fp32; all on one CUDA device,
    contiguous, hd in ``HEAD_DIMS``. -> (o (BH, T, hd) in r's dtype,
    sN (BH, hd, hd) fp32)."""
    global launches
    if r.device.type != "cuda":
        raise ValueError("wkv6 kernel needs CUDA tensors; the CPU path is "
                         "kernels.ref.wkv6_ref")
    build.check_no_grad("wkv6", r, k, v, w, u, s0)
    if r.dtype not in build.DTYPES:
        raise TypeError(f"wkv6 kernel supports fp32/bf16, got {r.dtype}")
    if w.dtype not in (torch.float32, r.dtype):
        raise TypeError(f"wkv6: w must be fp32 or {r.dtype}, got {w.dtype}")
    BH, T, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel supports hd in {HEAD_DIMS}, got {hd}")
    if T < 1:
        raise ValueError("wkv6 needs T >= 1")
    dev, dt = r.device, r.dtype
    for name, t in (("r", r), ("k", k), ("v", v)):
        build.check_tensor(name, t, (BH, T, hd), dt, dev)
    build.check_tensor("w", w, (BH, T, hd), w.dtype, dev)
    build.check_tensor("u", u, (BH, hd), torch.float32, dev)
    build.check_tensor("s0", s0, (BH, hd, hd), torch.float32, dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    groups, cols = plan(BH, hd, n_sm)
    o = torch.empty_like(r)
    sN = torch.empty_like(s0)
    fn = build.load("wkv6")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), o.data_ptr(), sN.data_ptr(),
                 BH, T, hd, hd // groups, cols, build.DTYPES[dt],
                 build.DTYPES[w.dtype], stream)
    build.check("wkv6", err)
    launches += 1
    return o, sN
