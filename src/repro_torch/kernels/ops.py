"""Device dispatch: a CPU tensor takes the kernel's plain PyTorch version, a
CUDA tensor launches the hand-written kernel (which raises if it cannot
build or launch; there is no fallback), and a meta tensor (the dry run's
shape propagation) takes the kernel's stand-in in ``kernels.meta``, which
counts the launch and computes nothing. Under a gradient B4 and B5 go
through their autograd Functions (``WKV6``, ``SelectiveScan``), whose
backward is a kernel on CUDA and a plain reverse-time loop on the CPU; B1
always goes through ``MoEFFN``."""
from __future__ import annotations

from repro_torch.core.slot_cache import EXPERT_WEIGHT_NAMES
from repro_torch.kernels import build, meta, ref
from repro_torch.kernels.decode_split import decode_scores as _scores
from repro_torch.kernels.decode_split import decode_values as _values
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.moe_ffn import MoEFFN, moe_ffn, moe_ffn_quant
from repro_torch.kernels.selective_scan import SelectiveScan
from repro_torch.kernels.selective_scan import selective_scan as _scan
from repro_torch.kernels.wkv6 import WKV6, wkv6


def moe_expert_ffn(xg, w_gate, w_up, w_down, *, act: str = "swiglu"):
    """Grouped expert FFN (E, C, d) -> (E, C, d); on CUDA (and its meta
    stand-in) B1 through ``MoEFFN``, so a gradient flows through the
    kernel's output."""
    if xg.device.type == "cpu":
        return ref.moe_ffn_ref(xg, w_gate, w_up, w_down, act=act)
    return MoEFFN.apply(xg, w_gate, w_up, w_down, act)


def moe_expert_ffn_slots(xg, bufs, slot_ids, *, act: str = "swiglu",
                         out_dtype=None):
    """Grouped expert FFN over slot-cache buffers ``bufs`` ({w_gate?, w_up,
    w_down} (n_slots, ...) plus ``<name>_scale`` rows under int8) for the
    (E,) int32 expert -> slot table ``slot_ids``. A wire in x's dtype with
    no scales takes B1 (``moe_ffn`` with ``slot_ids``), fp16/int8 take B2
    (``moe_ffn_quant``), as the reference's ``moe_ffn_quant`` delegates.
    -> (E, C, d) in ``out_dtype`` (default x's dtype)."""
    ws = [bufs.get(n) for n in EXPERT_WEIGHT_NAMES]
    ss = [bufs.get(n + "_scale") for n in EXPERT_WEIGHT_NAMES]
    if xg.device.type == "cpu":
        return ref.moe_ffn_quant_ref(xg, *ws, *ss, slot_ids, act=act,
                                     out_dtype=out_dtype)
    if xg.device.type == "meta":
        return meta.moe_ffn(xg, *ws, out_dtype=out_dtype)
    if ss[1] is None and ws[1].dtype == xg.dtype:
        y = moe_ffn(xg, *ws, act=act, slot_ids=slot_ids)
        return y if out_dtype is None else y.to(out_dtype)
    return moe_ffn_quant(xg, *ws, *ss, slot_ids, act=act, out_dtype=out_dtype)


def decode_attention(q, k, v, cache_len, softcap: float = 0.0, *,
                     return_lse: bool = False):
    """Single-token GQA attention over a per-slot-length KV cache, with an
    optional logit softcap; ``return_lse``: -> (out, each row's fp32
    log-sum-exp (B, H)), for merging blocks of a cache split across
    devices (``flash_decode``)."""
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k, v, cache_len, softcap,
                                    return_lse=return_lse)
    if q.device.type == "meta":
        return meta.flash_decode(q, k, v, return_lse=return_lse)
    return flash_decode(q, k, v, cache_len, softcap, return_lse=return_lse)


def decode_scores(q, k, cache_len, scale: float):
    """B3-qk: one head_dim slice's partial decode scores (B, H, S) fp32 of
    q (B, H, hd_l) against k (B, S, Hkv, hd_l), ``scale`` 1/sqrt of the
    whole head_dim, 0 past each row's length (``decode_split``)."""
    if q.device.type == "cpu":
        return ref.decode_scores_ref(q, k, cache_len, scale)
    if q.device.type == "meta":
        return meta.decode_scores(q, k)
    return _scores(q, k, cache_len, scale)


def decode_values(scores, v, cache_len, softcap: float = 0.0, *,
                  return_lse: bool = False):
    """B3-pv: the softcapped, masked softmax of the summed scores (B, H, S)
    times one head_dim slice of V (B, S, Hkv, hd_l) -> (B, H, hd_l), and
    with ``return_lse`` each row's fp32 log-sum-exp (``decode_split``)."""
    if v.device.type == "cpu":
        return ref.decode_values_ref(scores, v, cache_len, softcap,
                                     return_lse=return_lse)
    if v.device.type == "meta":
        return meta.decode_values(scores, v, return_lse=return_lse)
    return _values(scores, v, cache_len, softcap, return_lse=return_lse)


def wkv_scan(r, k, v, w, u, s0):
    """RWKV6 recurrence over (BH, T, hd) rows from state s0 (BH, hd, hd).
    -> (o in r's dtype, sN fp32). Under a gradient through ``WKV6``;
    otherwise the plain version (CPU) or the raw launch (CUDA)."""
    if r.device.type == "meta":
        return meta.wkv6(r, k, v, w, u, s0)
    if build.needs_grad(r, k, v, w, u, s0):
        return WKV6.apply(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return ref.wkv6_ref(r, k, v, w, u, s0)
    return wkv6(r, k, v, w, u, s0)


def selective_scan(x, dt, A, Bm, Cm, h0):
    """Mamba selective scan over (B, T, D) rows from state h0 (B, D, N).
    -> (y (B, T, D) fp32 before the D skip, hT fp32). Under a gradient
    through ``SelectiveScan``; otherwise the plain version (CPU) or the
    raw launch (CUDA)."""
    if x.device.type == "meta":
        return meta.selective_scan(x, dt, A, Bm, Cm, h0)
    if build.needs_grad(x, dt, A, Bm, Cm, h0):
        return SelectiveScan.apply(x, dt, A, Bm, Cm, h0)
    if x.device.type == "cpu":
        return ref.selective_scan_ref(x, dt, A, Bm, Cm, h0)
    return _scan(x, dt, A, Bm, Cm, h0)
