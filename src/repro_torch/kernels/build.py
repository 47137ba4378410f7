"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/<name>-<hash>.so`` next to this
file (the directory is git-ignored), compiled for ``sm_90a`` at first use.
The hash covers the sources and flags, so an edited kernel is rebuilt and
a stale library is never loaded. Every kernel exports one ``extern "C"``
launch function taking raw device pointers and the CUDA stream as
``c_void_p`` and returning ``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
KERNELS = ("moe_ffn", "moe_ffn_quant", "flash_decode", "wkv6",
           "selective_scan", "wkv6_bwd", "selective_scan_bwd",
           "decode_scores", "decode_values")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # codes of csrc/common.cuh
WIRE_DTYPES = {torch.float16: 2, torch.int8: 3}
# B4/B5 under a gradient: the forwards store the fp32 state before every
# CKPT_STEPS-th step and the backwards recompute from those checkpoints; B5's
# backward takes SCAN_BWD_CHANNELS channels a block, one row of its partials
# each. These are the only copies: nvcc gets them as -D flags (csrc/common.cuh)
# and the wrappers size their buffers from them.
CKPT_STEPS = 8
SCAN_BWD_CHANNELS = 32
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DCKPT_STEPS={CKPT_STEPS}",
              f"-DSCAN_BWD_CHANNELS={SCAN_BWD_CHANNELS}")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # xg, w_gate, w_up, w_down, slot_ids, flags, h, y, E, C, d, f, act,
    # dtype, stream
    "moe_ffn": ("moe_ffn_launch", [_P] * 8 + [_I] * 6 + [_P]),
    # xg, w_gate, w_up, w_down, s_gate, s_up, s_down, slot_ids, flags, h,
    # y, E, C, d, f, act, x_dtype, w_dtype, out_dtype, stream
    "moe_ffn_quant": ("moe_ffn_quant_launch", [_P] * 11 + [_I] * 8 + [_P]),
    # q, k, v, lens, out, part, lse (or None), B, S, Hkv, rep, hd, splits,
    # split_len, scale, softcap, dtype, stream
    "flash_decode": ("flash_decode_launch",
                     [_P] * 7 + [_I] * 7 + [_F, _F, _I, _P]),
    # q, k, lens, scores, B, T, Hkv, rep, hd, scale, dtype, stream
    "decode_scores": ("decode_scores_launch",
                      [_P] * 4 + [_I] * 5 + [_F, _I, _P]),
    # scores, v, lens, out, part, lse (or None), B, T, Hkv, rep, hd,
    # splits, split_len, softcap, dtype, stream
    "decode_values": ("decode_values_launch",
                      [_P] * 6 + [_I] * 7 + [_F, _I, _P]),
    # r, k, v, w, u, s0, o, sN, ck (or None), BH, T, hd, rows, cols, dtype,
    # w_dtype, stream
    "wkv6": ("wkv6_launch", [_P] * 9 + [_I] * 7 + [_P]),
    # x, dt, A, Bm, Cm, h0, y, hT, ck (or None), B, T, D, N, dtype, stream
    "selective_scan": ("selective_scan_launch", [_P] * 9 + [_I] * 5 + [_P]),
    # r, k, v, w, u, ck, do, dsN, dr, dk, dv, dw, du, ds0, BH, T, hd, dtype,
    # w_dtype, stream
    "wkv6_bwd": ("wkv6_bwd_launch", [_P] * 14 + [_I] * 5 + [_P]),
    # x, dt, A, Bm, Cm, ck, dy, dhT, dx, ddt, dB, dC, dA, dh0, part,
    # dA_part, B, T, D, N, dtype, stream
    "selective_scan_bwd": ("selective_scan_bwd_launch",
                           [_P] * 16 + [_I] * 5 + [_P]),
}

# the backward kernels' layout queries, (hd, dtype, w_dtype, int[4]) and
# (N, dtype, int[4]) -> CTAs an SM, threads and shared bytes a CTA,
# registers a thread
_QUERIES = {
    "wkv6_bwd": ("wkv6_bwd_occupancy", [_I] * 3 + [_P]),
    "selective_scan_bwd": ("selective_scan_bwd_occupancy", [_I] * 2 + [_P]),
}
OCCUPANCY_KEYS = ("ctas_per_sm", "threads", "smem_bytes", "registers")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_logs: Dict[str, str] = {}   # name -> nvcc output of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists.
    -> (process, temporary output, final library path) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or none


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. -> name -> library path."""
    names = list(names)
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return {n: library_path(n) for n in names}


def load(name: str):
    """The launch function of kernel ``name`` (building it if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return getattr(lib, _SIGNATURES[name][0])


def occupancy(name: str, *args: int) -> Dict[str, int]:
    """The layout query of backward kernel ``name`` (``_QUERIES``) on the
    current device. -> ``OCCUPANCY_KEYS`` -> value."""
    load(name)
    fn_name, argtypes = _QUERIES[name]
    fn = getattr(_libs[name], fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    out = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    check(fn_name, fn(*args, ctypes.cast(out, ctypes.c_void_p)))
    return dict(zip(OCCUPANCY_KEYS, out))


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data is not 16-byte aligned (a
    kernel that copies its rows 16 bytes at a time takes only aligned
    ones)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_tensor(name, t, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this shape, dtype and
    device (the launch functions take raw pointers and trust all four)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def needs_grad(*tensors) -> bool:
    """Whether autograd would need a gradient through these tensors (None
    and non-tensors need none)."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def check_no_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through this launch. The
    kernel writes its outputs through raw pointers, so they have no
    ``grad_fn``: a backward would silently give no gradient to anything
    behind them."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{name} has no backward: run it under torch.no_grad() or "
            "torch.inference_mode()")


def check(name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
