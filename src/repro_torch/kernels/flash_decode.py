"""Single-token GQA decode attention on the GPU: wrapper of
``csrc/flash_decode.cu``.

Replaces the Pallas ``repro.kernels.flash_decode.flash_decode``. Takes CUDA
tensors only; the CPU path is ``ref.flash_decode_ref`` (dispatch lives in
``ops``). ``launches`` counts calls that launched the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lengths

launches = 0


def flash_decode(q, k, v, cache_len):
    """q: (B, H, hd); k/v: (B, S, Hkv, hd); cache_len: int or int tensor,
    scalar or (B,) per-slot valid lengths. -> (B, H, hd) in q's dtype."""
    global launches
    if q.device.type != "cuda":
        raise ValueError("flash_decode kernel needs CUDA tensors; the CPU "
                         "path is kernels.ref.flash_decode_ref")
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
    lens = lengths(cache_len, B, dev)
    out = torch.empty_like(q)
    fn = build.load("flash_decode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                 out.data_ptr(), B, S, Hkv, H // Hkv, hd, hd ** -0.5,
                 build.DTYPES[dt], stream)
    build.check("flash_decode", err)
    launches += 1
    return out
