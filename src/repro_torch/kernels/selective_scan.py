"""Mamba-1 selective scan on the GPU: wrapper of ``csrc/selective_scan.cu``.

B5. It has no Pallas counterpart: it replaces the reference's ``lax.scan``
over ``_ssm_params`` + ``_scan_chunk`` (``repro.models.mamba``), computing
``exp(dt * A)`` and ``(dt * x) * B`` on the fly instead of forming them as
(B, T, d_in, N) tensors. Takes CUDA tensors only; the CPU path is
``ref.selective_scan_ref`` (dispatch lives in ``ops``). One launch carries
the state over any T >= 1; decode is T = 1. ``launches`` counts calls that
launched the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

STATES = (8, 16)   # the d_state values in use: reduced configs, Jamba

launches = 0


def selective_scan(x, dt, A, Bm, Cm, h0):
    """x: (B, T, D) fp32 or bf16; dt: (B, T, D) fp32; A: (D, N) fp32;
    Bm, Cm: (B, T, N) in x's dtype; h0: (B, D, N) fp32; all on one CUDA
    device, contiguous, N in ``STATES``.
    -> (y (B, T, D) fp32, before the D skip; hT (B, D, N) fp32)."""
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
    fn = build.load("selective_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
                 B, T, D, N, build.DTYPES[x.dtype], stream)
    build.check("selective_scan", err)
    launches += 1
    return y, hT
