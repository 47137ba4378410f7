"""Grouped expert FFN on the GPU: wrapper of ``csrc/moe_ffn.cu``.

Replaces the Pallas ``repro.kernels.moe_ffn.moe_ffn``. Takes CUDA tensors
only; the CPU path is ``ref.moe_ffn_ref`` (dispatch lives in ``ops``).
``launches`` counts calls that launched the kernel (one per call, although
the kernel runs as two launches: up+activation, then down).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

ACTS = {"swiglu": 1, "geglu": 2, "relu2": 3, "gelu": 4}
GATED = ("swiglu", "geglu")

launches = 0


def moe_ffn(xg, w_gate, w_up, w_down, *, act: str = "swiglu"):
    """xg: (E, C, d); w_gate/w_up: (E, d, f) (``w_gate`` None for relu2 /
    gelu); w_down: (E, f, d); all on one CUDA device, fp32 or bf16.
    -> (E, C, d) in xg's dtype."""
    global launches
    if xg.device.type != "cuda":
        raise ValueError("moe_ffn kernel needs CUDA tensors; the CPU path "
                         "is kernels.ref.moe_ffn_ref")
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if (w_gate is not None) != (act in GATED):
        raise ValueError(f"{act} {'needs' if act in GATED else 'takes no'} "
                         "w_gate")
    if xg.dtype not in build.DTYPES:
        raise TypeError(f"moe_ffn kernel supports fp32/bf16, got {xg.dtype}")
    E, C, d = xg.shape
    f = w_up.shape[-1]
    dev, dt = xg.device, xg.dtype
    build.check_tensor("xg", xg, (E, C, d), dt, dev)
    build.check_tensor("w_up", w_up, (E, d, f), dt, dev)
    build.check_tensor("w_down", w_down, (E, f, d), dt, dev)
    if w_gate is not None:
        build.check_tensor("w_gate", w_gate, (E, d, f), dt, dev)
    h = torch.empty((E, C, f), dtype=dt, device=dev)
    y = torch.empty((E, C, d), dtype=dt, device=dev)
    fn = build.load("moe_ffn")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xg.data_ptr(),
                 w_gate.data_ptr() if w_gate is not None else None,
                 w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(),
                 y.data_ptr(), E, C, d, f, ACTS[act], build.DTYPES[dt], stream)
    build.check("moe_ffn", err)
    launches += 1
    return y
