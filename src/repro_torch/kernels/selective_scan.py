"""Mamba-1 selective scan on the GPU: wrapper of ``csrc/selective_scan.cu``.

B5. It has no Pallas counterpart: it replaces the reference's ``lax.scan``
over ``_ssm_params`` + ``_scan_chunk`` (``repro.models.mamba``), computing
``exp(dt * A)`` and ``(dt * x) * B`` on the fly instead of forming them as
(B, T, d_in, N) tensors; under a gradient ``csrc/selective_scan_bwd.cu``
stands for XLA's differentiation of that scan, and ``SelectiveScan`` puts
the pair on the autograd graph. The wrappers take CUDA tensors only; the
CPU path is ``ref.selective_scan_ref`` / ``ref.selective_scan_bwd_ref``
(dispatch lives in ``ops`` and ``SelectiveScan``). One launch carries the
state over any T >= 1; decode is T = 1. ``launches`` counts calls that
launched the forward kernel, ``bwd_launches`` the backward's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

STATES = (8, 16)   # the d_state values in use: reduced configs, Jamba
CKPT_STEPS = build.CKPT_STEPS        # steps between the state checkpoints
CHANNELS = build.SCAN_BWD_CHANNELS    # channels a backward block takes (its
                                      # partials' rows)

launches = 0
bwd_launches = 0


def checkpoints_shape(B: int, T: int, D: int, N: int):
    """The forward's state checkpoints under a gradient: the fp32 state
    before every ``CKPT_STEPS``-th step."""
    return (-(-T // CKPT_STEPS), B, D, N)


def partials_shape(B: int, T: int, D: int, N: int):
    """The backward's dB/dC partials: one row a block of ``CHANNELS``
    channels."""
    return (-(-D // CHANNELS), B, T, 2 * N)


def selective_scan(x, dt, A, Bm, Cm, h0, *, checkpoints: bool = False):
    """x: (B, T, D) fp32 or bf16; dt: (B, T, D) fp32; A: (D, N) fp32;
    Bm, Cm: (B, T, N) in x's dtype; h0: (B, D, N) fp32; all on one CUDA
    device, contiguous, N in ``STATES``.
    -> (y (B, T, D) fp32, before the D skip; hT (B, D, N) fp32), and with
    ``checkpoints`` the states ``selective_scan_backward`` recomputes from
    (``checkpoints_shape``, fp32) too."""
    global launches
    if x.device.type != "cuda":
        raise ValueError("selective_scan kernel needs CUDA tensors; the CPU "
                         "path is kernels.ref.selective_scan_ref")
    build.check_no_grad("selective_scan", x, dt, A, Bm, Cm, h0)
    if x.dtype not in build.DTYPES:
        raise TypeError(f"selective_scan supports fp32/bf16, got {x.dtype}")
    B, T, D = x.shape
    N = A.shape[-1]
    if N not in STATES:
        raise ValueError(f"selective_scan supports N in {STATES}, got {N}")
    if T < 1:
        raise ValueError("selective_scan needs T >= 1")
    dev, f32 = x.device, torch.float32
    build.check_tensor("x", x, (B, T, D), x.dtype, dev)
    build.check_tensor("dt", dt, (B, T, D), f32, dev)
    build.check_tensor("A", A, (D, N), f32, dev)
    build.check_tensor("Bm", Bm, (B, T, N), x.dtype, dev)
    build.check_tensor("Cm", Cm, (B, T, N), x.dtype, dev)
    build.check_tensor("h0", h0, (B, D, N), f32, dev)
    y = torch.empty((B, T, D), dtype=f32, device=dev)
    hT = torch.empty_like(h0)
    ck = (torch.empty(checkpoints_shape(B, T, D, N), dtype=f32, device=dev)
          if checkpoints else None)
    fn = build.load("selective_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
                 None if ck is None else ck.data_ptr(), B, T, D, N,
                 build.DTYPES[x.dtype], stream)
    build.check("selective_scan", err)
    launches += 1
    return (y, hT, ck) if checkpoints else (y, hT)


def selective_scan_backward(x, dt, A, Bm, Cm, ck, dy, dhT):
    """Gradients of ``selective_scan`` for the upstream ``dy`` (B, T, D)
    and ``dhT`` (B, D, N) fp32, from the forward's inputs and its
    checkpoints ``ck``. -> (dx in x's dtype, ddt fp32, dA (D, N) fp32, dB,
    dC in x's dtype, dh0 (B, D, N) fp32). The sums over channels (dB, dC)
    and batch rows (dA) go through per-block partials (``partials_shape``)
    and per-row partials and a fixed-order second pass, so two launches give
    the same bits."""
    global bwd_launches
    if x.device.type != "cuda":
        raise ValueError("selective_scan_backward needs CUDA tensors; the "
                         "CPU path is kernels.ref.selective_scan_bwd_ref")
    build.check_no_grad("selective_scan_backward", x, dt, A, Bm, Cm, ck, dy,
                        dhT)
    if x.dtype not in build.DTYPES:
        raise TypeError(f"selective_scan_backward supports fp32/bf16, got "
                        f"{x.dtype}")
    B, T, D = x.shape
    N = A.shape[-1]
    if N not in STATES:
        raise ValueError(f"selective_scan_backward supports N in {STATES}, "
                         f"got {N}")
    if T < 1:
        raise ValueError("selective_scan_backward needs T >= 1")
    dev, f32 = x.device, torch.float32
    build.check_tensor("x", x, (B, T, D), x.dtype, dev)
    build.check_tensor("dt", dt, (B, T, D), f32, dev)
    build.check_tensor("A", A, (D, N), f32, dev)
    build.check_tensor("Bm", Bm, (B, T, N), x.dtype, dev)
    build.check_tensor("Cm", Cm, (B, T, N), x.dtype, dev)
    build.check_tensor("ck", ck, checkpoints_shape(B, T, D, N), f32, dev)
    build.check_tensor("dy", dy, (B, T, D), f32, dev)
    build.check_tensor("dhT", dhT, (B, D, N), f32, dev)
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dh0 = torch.empty_like(dhT)
    part = torch.empty(partials_shape(B, T, D, N), dtype=f32, device=dev)
    dA_part = torch.empty((B, D, N), dtype=f32, device=dev)
    fn = build.load("selective_scan_bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in (x, dt, A, Bm, Cm, ck, dy, dhT, dx,
                                          ddt, dB, dC, dA, dh0, part,
                                          dA_part)),
                 B, T, D, N, build.DTYPES[x.dtype], stream)
    build.check("selective_scan_bwd", err)
    bwd_launches += 1
    return dx, ddt, dA, dB, dC, dh0


class SelectiveScan(torch.autograd.Function):
    """B5 on the autograd graph (``ops.selective_scan`` under a gradient):
    on CUDA the forward is ``selective_scan``'s launch plus its state
    checkpoints, the backward ``selective_scan_backward``; on the CPU the
    plain ``selective_scan_ref`` and ``selective_scan_bwd_ref``."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0):
        if x.device.type == "cpu":
            y, hT = ref.selective_scan_ref(x, dt, A, Bm, Cm, h0)
            ctx.save_for_backward(x, dt, A, Bm, Cm, h0)
            return y, hT
        y, hT, ck = selective_scan(x, dt, A, Bm, Cm, h0, checkpoints=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, ck)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, A, Bm, Cm, state = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = ref.selective_scan_bwd_ref(x, dt, A, Bm, Cm, state, dy,
                                               dhT)
        else:
            grads = selective_scan_backward(x, dt, A, Bm, Cm, state,
                                            dy.float().contiguous(),
                                            dhT.float().contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
