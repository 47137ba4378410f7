"""Meta-device stand-ins for the kernels (the dry run's shape propagation).

A meta tensor has a shape and a dtype and no data. The dry run
(``launch/dryrun.py``) traces a whole step over meta tensors to count its
FLOPs, bytes and memory (``launch/cost_analysis.py``). A kernel called on
meta tensors is not run, and neither is its plain version (B4's and B5's
loop over T in Python, 32768 steps at prefill): a stand-in makes outputs of
the kernel's shapes and dtypes and tells every counter in ``COUNTERS``
that one launch ran, with the FLOPs of the kernel's products and the bytes
it reads and writes (each input once, each output once, as
``chip_smoke.py::bound`` counts them; every expert's weights, since meta
tensors carry no routing). CUDA tensors never come here: they launch the
kernel or raise.

Under autograd, B1 keeps ``MoEFFN``'s backward (its ``torch.bmm``
products, traced like any other op). B4 and B5 stand in for their
autograd Functions: under a gradient the forward also writes the state
checkpoints, and the backward stand-in counts the backward kernel's own
launch: its products (``wkv6_bwd.cu``, ``selective_scan_bwd.cu``), the
inputs, checkpoints and output gradients it reads, the input gradients it
writes, and B5's per-block partials (written, then read by its second
pass). Any other stand-in raises under a gradient, as its kernel does.
A stand-in refuses the head dims its kernel refuses (the wrappers'
``HEAD_DIMS``), so a dry-run record is ok only where the card would run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_split import HEAD_DIMS as SPLIT_HEAD_DIMS
from repro_torch.kernels.flash_decode import HEAD_DIMS as B3_HEAD_DIMS
from repro_torch.kernels.selective_scan import \
    checkpoints_shape as scan_checkpoints
from repro_torch.kernels.selective_scan import partials_shape
from repro_torch.kernels.wkv6 import HEAD_DIMS as B4_HEAD_DIMS
from repro_torch.kernels.wkv6 import checkpoints_shape as wkv_checkpoints

# the active counters: objects with ``kernel(name, inputs, outputs, flops)``
COUNTERS = []


def _report(name, inputs, outputs, flops) -> None:
    ins = [t for t in inputs if isinstance(t, torch.Tensor)]
    outs = [t for t in outputs if isinstance(t, torch.Tensor)]
    for c in COUNTERS:
        c.kernel(name, ins, outs, float(flops))


def _check_hd(name, hd, head_dims, what="hd"):
    if hd not in head_dims:
        raise ValueError(f"{name} kernel takes {what} in {head_dims}, got "
                         f"{hd}")


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


class _StandIn(torch.autograd.Function):
    """A kernel stand-in on the autograd graph (``stand_in``)."""

    @staticmethod
    def forward(ctx, name, specs, flops, bwd, *inputs):
        ctx.name, ctx.bwd = name, bwd
        ctx.specs = [None if t is None else (t.shape, t.dtype)
                     for t in inputs]
        outs = tuple(_empty(s, d) for s, d in specs)
        saved = () if bwd is None else tuple(
            _empty(s, d) for s, d in bwd["saved"])
        _report(name, inputs, outs + saved, flops)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        bwd = ctx.bwd
        if bwd is None:
            raise NotImplementedError(f"{ctx.name} has no backward")
        gin = tuple(
            _empty(*s) if s is not None and need else None
            for s, need in zip(ctx.specs, ctx.needs_input_grad[4:]))
        scratch = [_empty(s, d) for s, d in bwd["scratch"]]
        reads = ([_empty(*ctx.specs[i]) for i in bwd["reads"]]
                 + [_empty(s, d) for s, d in bwd["saved"]] + list(grads)
                 + scratch)
        writes = [_empty(*s) for s in ctx.specs if s is not None] + scratch
        _report(f"{ctx.name} backward", reads, writes, bwd["flops"])
        return (None, None, None, None) + gin


def stand_in(name, inputs, specs, flops, bwd=None):
    """Outputs of shapes and dtypes ``specs`` [(shape, dtype)] for kernel
    ``name`` over ``inputs``, reported to the counters with ``flops``.
    ``bwd`` (under a gradient): {"saved": [(shape, dtype)] the forward also
    writes, "reads": indices of the inputs the backward reads again,
    "scratch": [(shape, dtype)] it writes and reads back, "flops": its
    products}; the backward writes a gradient for every input."""
    return _StandIn.apply(name, specs, flops, bwd, *inputs)


def moe_ffn(xg, w_gate, w_up, w_down, out_dtype=None):
    """B1 (or B2 over slot buffers): (E, C, d) -> (E, C, d). Products:
    x·W_gate, x·W_up (E, C, d)x(d, f) and h·W_down."""
    E, C, d = xg.shape
    f = w_up.shape[-1]
    n_mm = 3 if w_gate is not None else 2
    (y,) = stand_in("moe_ffn", (xg, w_gate, w_up, w_down),
                    [((E, C, d), out_dtype or xg.dtype)],
                    n_mm * 2.0 * E * C * d * f)
    return y


def flash_decode(q, k, v, return_lse: bool = False):
    """B3: q (B, H, hd) over k/v (B, S, Hkv, hd) -> (B, H, hd), and with
    ``return_lse`` each row's fp32 log-sum-exp (B, H). Products: q·Kᵀ and
    p·V over every cache position."""
    B, H, hd = q.shape
    _check_hd("flash_decode", hd, B3_HEAD_DIMS)
    S = k.shape[1]
    specs = [(q.shape, q.dtype)]
    if return_lse:
        specs.append(((B, H), torch.float32))
    outs = stand_in("flash_decode", (q, k, v), specs,
                    2 * 2.0 * B * H * S * hd)
    return outs if return_lse else outs[0]


def decode_scores(q, k):
    """B3-qk: q (B, H, hd_l) against k (B, S, Hkv, hd_l) -> the partial
    scores (B, H, S) fp32. Product: q·Kᵀ over every cache position."""
    B, H, hd = q.shape
    _check_hd("decode_scores", hd, SPLIT_HEAD_DIMS,
              "a head_dim slice")
    S = k.shape[1]
    (scores,) = stand_in("decode_scores", (q, k),
                         [((B, H, S), torch.float32)], 2.0 * B * H * S * hd)
    return scores


def decode_values(scores, v, return_lse: bool = False):
    """B3-pv: the summed scores (B, H, S) over v (B, S, Hkv, hd_l) ->
    (B, H, hd_l), and with ``return_lse`` each row's fp32 log-sum-exp
    (B, H). Product: p·V over every cache position."""
    B, H, S = scores.shape
    hd = v.shape[3]
    _check_hd("decode_values", hd, SPLIT_HEAD_DIMS,
              "a head_dim slice")
    specs = [((B, H, hd), v.dtype)]
    if return_lse:
        specs.append(((B, H), torch.float32))
    outs = stand_in("decode_values", (scores, v), specs,
                    2.0 * B * H * S * hd)
    return outs if return_lse else outs[0]


def wkv6(r, k, v, w, u, s0):
    """B4: (BH, T, hd) rows from s0 (BH, hd, hd) -> (o, sN fp32). Product:
    r_t·S per step (the state update is elementwise). Backward
    (``wkv6_bwd.cu``): 4 products a state element and step (S·do, A·v,
    Aᵀ·k and G ⊙ S's row sums), reading r/k/v/w/u, the checkpoints and
    the output gradients."""
    BH, T, hd = r.shape
    _check_hd("wkv6", hd, B4_HEAD_DIMS)
    inputs = (r, k, v, w, u, s0)
    bwd = None
    if build.needs_grad(*inputs):
        bwd = {"saved": [(wkv_checkpoints(BH, T, hd), torch.float32)],
               "reads": range(5), "scratch": [],
               "flops": 8.0 * BH * T * hd * hd}
    return stand_in("wkv6", inputs,
                    [(r.shape, r.dtype), (s0.shape, torch.float32)],
                    2.0 * BH * T * hd * hd, bwd)


def selective_scan(x, dt, A, Bm, Cm, h0):
    """B5: (B, T, D) rows from h0 (B, D, N) -> (y fp32, hT fp32). Product:
    h_t·C_t per step (the state update is elementwise). Backward
    (``selective_scan_bwd.cu``): 5 products a state element and step (the
    sums of dC, dB, dx, ddt and dA), reading x/dt/A/B/C, the checkpoints
    and the output gradients, through per-block partials of dB/dC and
    per-row partials of dA."""
    B, T, D = x.shape
    N = h0.shape[-1]
    inputs = (x, dt, A, Bm, Cm, h0)
    f32 = torch.float32
    bwd = None
    if build.needs_grad(*inputs):
        bwd = {"saved": [(scan_checkpoints(B, T, D, N), f32)],
               "reads": range(5),
               "scratch": [(partials_shape(B, T, D, N), f32),
                           ((B, D, N), f32)],
               "flops": 10.0 * B * T * D * N}
    return stand_in("selective_scan", inputs,
                    [(x.shape, f32), (h0.shape, f32)],
                    2.0 * B * T * D * N, bwd)
