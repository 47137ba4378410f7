"""RWKV6 recurrence on the GPU: wrappers of ``csrc/wkv6.cu`` and its
backward ``csrc/wkv6_bwd.cu``, and ``WKV6``, the pair on the autograd graph.

Replaces the Pallas ``repro.kernels.wkv6.wkv6`` (B4), and under a gradient
XLA's differentiation of the reference's scan. The wrappers take CUDA
tensors only; the CPU path is ``ref.wkv6_ref`` / ``ref.wkv6_bwd_ref``
(dispatch lives in ``ops`` and ``WKV6``). There is no ``chunk`` argument:
one launch carries the state over any T >= 1. Each (b, h) row's hd x hd
state is split over blocks by columns and over warps by rows (``plan``).
``launches`` counts calls that launched the forward kernel,
``bwd_launches`` the backward's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64)
COLS = 32         # state columns a block takes: a warp's lanes ...
FEW_COLS = 16     # ... or half, for more blocks
ROWS = 8          # state rows a thread keeps in registers: a short chain ...
MANY_ROWS = 16    # ... or twice that, for fewer partial sums
BLOCKS_PER_SM = 2
CKPT_STEPS = build.CKPT_STEPS   # steps between the state checkpoints

launches = 0
bwd_launches = 0


def checkpoints_shape(BH: int, T: int, hd: int):
    """The forward's state checkpoints under a gradient: the fp32 state
    before every ``CKPT_STEPS``-th step."""
    return (BH, -(-T // CKPT_STEPS), hd, hd)


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


def wkv6(r, k, v, w, u, s0, *, checkpoints: bool = False):
    """r/k/v: (BH, T, hd) fp32 or bf16; w: (BH, T, hd) fp32 or r's dtype;
    u: (BH, hd) and s0: (BH, hd, hd) fp32; all on one CUDA device,
    contiguous, hd in ``HEAD_DIMS``. -> (o (BH, T, hd) in r's dtype,
    sN (BH, hd, hd) fp32), and with ``checkpoints`` the states
    ``wkv6_backward`` recomputes from (``checkpoints_shape``, fp32) too."""
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
    ck = (torch.empty(checkpoints_shape(BH, T, hd), dtype=torch.float32,
                      device=dev) if checkpoints else None)
    fn = build.load("wkv6")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), o.data_ptr(), sN.data_ptr(),
                 None if ck is None else ck.data_ptr(), BH, T, hd,
                 hd // groups, cols, build.DTYPES[dt],
                 build.DTYPES[w.dtype], stream)
    build.check("wkv6", err)
    launches += 1
    return (o, sN, ck) if checkpoints else (o, sN)


def wkv6_backward(r, k, v, w, u, ck, do, dsN):
    """Gradients of ``wkv6`` for the upstream ``do`` (BH, T, hd) in r's
    dtype and ``dsN`` (BH, hd, hd) fp32, from the forward's inputs and its
    checkpoints ``ck``. -> (dr, dk, dv in r's dtype, dw in w's dtype,
    du (BH, hd) fp32, ds0 (BH, hd, hd) fp32). One block a row: every sum
    stays in its block and has a fixed order, so two launches give the same
    bits."""
    global bwd_launches
    if r.device.type != "cuda":
        raise ValueError("wkv6_backward needs CUDA tensors; the CPU path is "
                         "kernels.ref.wkv6_bwd_ref")
    build.check_no_grad("wkv6_backward", r, k, v, w, u, ck, do, dsN)
    if r.dtype not in build.DTYPES:
        raise TypeError(f"wkv6_backward supports fp32/bf16, got {r.dtype}")
    if w.dtype not in (torch.float32, r.dtype):
        raise TypeError(f"wkv6_backward: w must be fp32 or {r.dtype}, got "
                        f"{w.dtype}")
    BH, T, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6_backward supports hd in {HEAD_DIMS}, got "
                         f"{hd}")
    if T < 1:
        raise ValueError("wkv6_backward needs T >= 1")
    dev, dt, f32 = r.device, r.dtype, torch.float32
    for name, t in (("r", r), ("k", k), ("v", v), ("do", do)):
        build.check_tensor(name, t, (BH, T, hd), dt, dev)
    build.check_tensor("w", w, (BH, T, hd), w.dtype, dev)
    build.check_tensor("u", u, (BH, hd), f32, dev)
    build.check_tensor("ck", ck, checkpoints_shape(BH, T, hd), f32, dev)
    build.check_tensor("dsN", dsN, (BH, hd, hd), f32, dev)
    r, k, v, w, u, ck, do, dsN = (build.aligned16(t) for t in (
        r, k, v, w, u, ck, do, dsN))
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du = torch.empty_like(u)
    ds0 = torch.empty_like(dsN)
    fn = build.load("wkv6_bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in (r, k, v, w, u, ck, do, dsN, dr, dk,
                                          dv, dw, du, ds0)),
                 BH, T, hd, build.DTYPES[dt], build.DTYPES[w.dtype], stream)
    build.check("wkv6_bwd", err)
    bwd_launches += 1
    return dr, dk, dv, dw, du, ds0


class WKV6(torch.autograd.Function):
    """B4 on the autograd graph (``ops.wkv_scan`` under a gradient): on CUDA
    the forward is ``wkv6``'s launch plus its state checkpoints, the
    backward ``wkv6_backward``; on the CPU the plain ``wkv6_ref`` and
    ``wkv6_bwd_ref``. ``u``'s gradient is per row: the autograd engine
    sums it over the batch through the model's ``expand``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        if r.device.type == "cpu":
            o, sN = ref.wkv6_ref(r, k, v, w, u, s0)
            ctx.save_for_backward(r, k, v, w, u, s0)
            return o, sN
        o, sN, ck = wkv6(r, k, v, w, u, s0, checkpoints=True)
        ctx.save_for_backward(r, k, v, w, u, ck)
        return o, sN

    @staticmethod
    def backward(ctx, do, dsN):
        r, k, v, w, u, state = ctx.saved_tensors
        if r.device.type == "cpu":
            grads = ref.wkv6_bwd_ref(r, k, v, w, u, state, do, dsN)
        else:
            grads = wkv6_backward(r, k, v, w, u, state,
                                  do.to(r.dtype).contiguous(),
                                  dsN.float().contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
