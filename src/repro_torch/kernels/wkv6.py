"""RWKV6 recurrence on the GPU: wrapper of ``csrc/wkv6.cu``.

Replaces the Pallas ``repro.kernels.wkv6.wkv6`` (B4). Takes CUDA tensors
only; the CPU path is ``ref.wkv6_ref`` (dispatch lives in ``ops``). There is
no ``chunk`` argument: one launch carries the state over any T >= 1.
``launches`` counts calls that launched the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64)

launches = 0


def wkv6(r, k, v, w, u, s0):
    """r/k/v: (BH, T, hd) fp32 or bf16; w: (BH, T, hd) fp32 or r's dtype;
    u: (BH, hd) and s0: (BH, hd, hd) fp32; all on one CUDA device,
    contiguous, hd in ``HEAD_DIMS``. -> (o (BH, T, hd) in r's dtype,
    sN (BH, hd, hd) fp32)."""
    global launches
    if r.device.type != "cuda":
        raise ValueError("wkv6 kernel needs CUDA tensors; the CPU path is "
                         "kernels.ref.wkv6_ref")
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
    o = torch.empty_like(r)
    sN = torch.empty_like(s0)
    fn = build.load("wkv6")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), o.data_ptr(), sN.data_ptr(),
                 BH, T, hd, build.DTYPES[dt], build.DTYPES[w.dtype], stream)
    build.check("wkv6", err)
    launches += 1
    return o, sN
