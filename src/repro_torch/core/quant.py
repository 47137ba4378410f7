"""Expert wire formats — the quantized transfer/storage tier (DESIGN.md §7).

Experts cross the host→device link far more often than they are computed
with (every cache miss re-ships the same read-only weights), so the wire
dtype is a latency knob independent of the compute dtype: the slot cache
ships fp16 or int8 and the consuming kernel dequantizes on device, with the
GEMM accumulating in fp32 either way.

Formats (per expert weight matrix, host-side, numpy):

* ``fp32`` — the master dtype; no transform, bit-faithful (the identity
  wire keeps the slot path bit-identical to the fused all-resident step).
* ``fp16`` — plain ``astype``; no scales. Relative error ~2^-11.
* ``int8`` — symmetric per-output-channel quantization: for a matrix of
  shape ``(in, out)`` the scale is ``maxabs(column)/127`` over axis 0,
  giving one fp32 scale per output channel (``w_gate``/``w_up``: (f,)
  scales; ``w_down``: (d,) scales). Dequant is ``q.astype(f32) * scale``,
  broadcast over the input axis. Relative error ~1/127 per channel.

The same module derives the *analytic* wire byte count used by the event
simulator (`OffloadConfig.wire_expert_bytes`), so the sim's byte model and
the real slot path can never disagree: both sides compute bytes from one
``transfer_dtype`` value. The wire never widens the master dtype — with
bf16 masters an fp32 wire clamps to 2 bytes/param (factor 1.0).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

WIRE_DTYPES = ("fp32", "fp16", "int8")
_ITEMSIZE = {"fp32": 4, "fp16": 2, "int8": 1}
_NP_DTYPE = {"fp16": np.float16, "int8": np.int8}

SCALE_SUFFIX = "_scale"


def wire_itemsize(transfer_dtype: str, master_itemsize: int = 4) -> int:
    """Bytes per weight element on the wire (clamped to the master size)."""
    if transfer_dtype not in _ITEMSIZE:
        raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}; "
                         f"expected one of {WIRE_DTYPES}")
    return min(_ITEMSIZE[transfer_dtype], master_itemsize)


def wire_np_dtype(transfer_dtype: str, master_dtype) -> np.dtype:
    """Numpy storage dtype of the wire tier for one weight leaf."""
    if transfer_dtype == "fp32":
        return np.dtype(master_dtype)
    return np.dtype(_NP_DTYPE[transfer_dtype])


def scale_name(name: str) -> str:
    return name + SCALE_SUFFIX


def is_scale_name(name: str) -> bool:
    return name.endswith(SCALE_SUFFIX)


def quantize_weight(w: np.ndarray, transfer_dtype: str
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """-> (wire array, fp32 per-output-channel scales | None).

    ``w``: one expert weight matrix ``(in, out)`` (any leading layout where
    the *last* axis is the output channel — true for ``w_gate``/``w_up``
    ``(d, f)`` and ``w_down`` ``(f, d)``)."""
    if transfer_dtype == "fp32":
        return w, None
    if transfer_dtype == "fp16":
        return w.astype(np.float16), None
    if transfer_dtype == "int8":
        w32 = np.asarray(w, np.float32)
        maxabs = np.max(np.abs(w32), axis=tuple(range(w32.ndim - 1)))
        scale = (maxabs / 127.0).astype(np.float32)
        safe = np.where(scale > 0, scale, 1.0).astype(np.float32)
        q = np.clip(np.rint(w32 / safe), -127, 127).astype(np.int8)
        return q, safe
    raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")


def dequantize_weight(q: np.ndarray, scale: Optional[np.ndarray]
                      ) -> np.ndarray:
    """Host-side inverse of :func:`quantize_weight` (tests/reference)."""
    if scale is None:
        return np.asarray(q, np.float32)
    return np.asarray(q, np.float32) * scale


def quantize_expert(weights: Dict[str, np.ndarray], transfer_dtype: str
                    ) -> Dict[str, np.ndarray]:
    """Quantize one expert's weight dict; int8 adds ``<name>_scale`` leaves
    next to each quantized weight (the layout the slot buffers mirror)."""
    out: Dict[str, np.ndarray] = {}
    for name, w in weights.items():
        q, scale = quantize_weight(w, transfer_dtype)
        out[name] = q
        if scale is not None:
            out[scale_name(name)] = scale
    return out


def wire_nbytes(weights: Dict[str, np.ndarray]) -> int:
    """Exact byte count of one expert's wire image (incl. scale leaves)."""
    return int(sum(a.nbytes for a in weights.values()))


# -- analytic mirror for the event simulator --------------------------------

def expert_scale_params(arch) -> int:
    """fp32 scale elements per expert under int8 (one per output channel:
    f for w_up, f for w_gate when the activation is gated, d for w_down)."""
    f = arch.moe.d_expert
    d = arch.d_model
    n = f + d
    if arch.act in ("swiglu", "geglu"):
        n += f
    return n


def sim_wire_expert_bytes(arch, bytes_per_param: int,
                          transfer_dtype: str) -> int:
    """Analytic per-expert wire bytes for trace mode — the value handed to
    ``MemSim`` so simulated transfer times reflect the wire dtype. Model
    mode overrides this with the host store's *measured* wire image size
    (they agree exactly when the master dtype matches ``bytes_per_param``)."""
    from repro_torch.config import _ffn_params
    params = _ffn_params(arch, arch.moe.d_expert)
    b = params * wire_itemsize(transfer_dtype, bytes_per_param)
    if transfer_dtype == "int8":
        b += expert_scale_params(arch) * 4
    return int(b)
