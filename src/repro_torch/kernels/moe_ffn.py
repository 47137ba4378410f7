"""Grouped expert FFN on the GPU: wrappers of ``csrc/moe_ffn.cu`` and
``csrc/moe_ffn_quant.cu``.

``moe_ffn`` replaces the Pallas ``repro.kernels.moe_ffn.moe_ffn`` (B1);
``moe_ffn_quant`` replaces ``repro.kernels.moe_ffn.moe_ffn_quant`` as
reached through ``moe_ffn_slots`` (B2): fp16/int8 slot-cache buffers,
dequantized in the kernel, with the expert -> slot table folded into its
addressing. Both take CUDA tensors only; the CPU paths are
``ref.moe_ffn_ref`` / ``ref.moe_ffn_quant_ref`` (dispatch lives in
``ops``). ``launches`` / ``quant_launches`` count calls that launched each
kernel (one per call, although each call runs as three launches: a scan
of xg's non-zero rows, up+activation, then down). Both skip what nothing
was routed to: a zero row of xg gives a +0.0 row, and an expert with no
non-zero row has none of its weights (or scales) read.

Under autograd B1 runs as ``MoEFFN``: its forward is the same launch, with
the same bits; its backward is ``moe_ffn_backward``, plain batched products
(the reference differentiates its jnp ``grouped_expert_ffn`` outside any
Pallas kernel, so there is no TPU backward kernel to port). Every raw
wrapper raises when a gradient is asked of it (``build.check_no_grad``):
its output is written through pointers and would sit off the graph. B2 is
decode-only and has no backward.

``moe_ffn_sharded`` and ``moe_ffn_sharded_slots`` run the same launches per
shard of an expert mesh (expert parallelism): one B1 or B2 launch a shard.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, meta

ACTS = {"swiglu": 1, "geglu": 2, "relu2": 3, "gelu": 4}
GATED = ("swiglu", "geglu")

launches = 0
quant_launches = 0


def _check_act(act: str, w_gate) -> None:
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if (w_gate is not None) != (act in GATED):
        raise ValueError(f"{act} {'needs' if act in GATED else 'takes no'} "
                         "w_gate")


def _check_weights(xg, w_gate, w_up, w_down, dtype, slot_ids):
    """-> (E, C, d, f, n) after checking the weights' shapes: (n, d, f) /
    (n, f, d), with n = E unless ``slot_ids`` (E,) int32 indexes them."""
    E, C, d = xg.shape
    f = w_up.shape[-1]
    dev = xg.device
    n = w_up.shape[0] if slot_ids is not None else E
    build.check_tensor("w_up", w_up, (n, d, f), dtype, dev)
    build.check_tensor("w_down", w_down, (n, f, d), dtype, dev)
    if w_gate is not None:
        build.check_tensor("w_gate", w_gate, (n, d, f), dtype, dev)
    if slot_ids is not None:
        build.check_tensor("slot_ids", slot_ids, (E,), torch.int32, dev)
    return E, C, d, f, n


def _ptr(t):
    return t.data_ptr() if t is not None else None


def moe_ffn(xg, w_gate, w_up, w_down, *, act: str = "swiglu",
            slot_ids=None):
    """xg: (E, C, d); w_gate/w_up: (E, d, f) (``w_gate`` None for relu2 /
    gelu); w_down: (E, f, d); all on one CUDA device, fp32 or bf16.
    ``slot_ids``: optional (E,) int32 on the device; the weights are then
    slot buffers (n_slots, ...) and expert e reads slot ``slot_ids[e]``
    (each must lie in [0, n_slots): the kernel does not check). Rows of
    ``xg`` that are all zero give +0.0 rows, and an expert with no non-zero
    row has none of its weights read.
    -> (E, C, d) in xg's dtype."""
    global launches
    if xg.device.type != "cuda":
        raise ValueError("moe_ffn kernel needs CUDA tensors; the CPU path "
                         "is kernels.ref.moe_ffn_ref")
    build.check_no_grad("moe_ffn", xg, w_gate, w_up, w_down)
    _check_act(act, w_gate)
    if xg.dtype not in build.DTYPES:
        raise TypeError(f"moe_ffn kernel supports fp32/bf16, got {xg.dtype}")
    dev, dt = xg.device, xg.dtype
    build.check_tensor("xg", xg, tuple(xg.shape), dt, dev)
    E, C, d, f, _ = _check_weights(xg, w_gate, w_up, w_down, dt, slot_ids)
    # marks of xg's non-zero rows, then h
    flags = torch.empty((E * C,), dtype=torch.int32, device=dev)
    h = torch.empty((E, C, f), dtype=dt, device=dev)
    y = torch.empty((E, C, d), dtype=dt, device=dev)
    fn = build.load("moe_ffn")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xg.data_ptr(), _ptr(w_gate), w_up.data_ptr(),
                 w_down.data_ptr(), _ptr(slot_ids), flags.data_ptr(),
                 h.data_ptr(), y.data_ptr(), E, C, d, f, ACTS[act],
                 build.DTYPES[dt], stream)
    build.check("moe_ffn", err)
    launches += 1
    return y


def moe_ffn_quant(xg, w_gate, w_up, w_down, s_gate, s_up, s_down, slot_ids,
                  *, act: str = "swiglu", out_dtype=None):
    """Slot-indexed grouped expert FFN over fp16 or int8 wire weights.

    xg: (E, C, d) fp32 or bf16; w_gate/w_up: (n_slots, d, f) and w_down:
    (n_slots, f, d), all fp16 or all int8 (``w_gate`` None for relu2 /
    gelu); s_gate/s_up: (n_slots, f) and s_down: (n_slots, d) fp32
    per-output-channel scales, given for int8 and None for fp16;
    slot_ids: (E,) int32, each in [0, n_slots) (the kernel does not check).
    Rows of ``xg`` that are all zero give +0.0 rows, and an expert with no
    non-zero row reads neither its slot's weights nor its scales.
    -> (E, C, d) in ``out_dtype`` (fp32 or bf16; default xg's dtype)."""
    global quant_launches
    if xg.device.type != "cuda":
        raise ValueError("moe_ffn_quant kernel needs CUDA tensors; the CPU "
                         "path is kernels.ref.moe_ffn_quant_ref")
    build.check_no_grad("moe_ffn_quant", xg, w_gate, w_up, w_down)
    _check_act(act, w_gate)
    out_dtype = xg.dtype if out_dtype is None else out_dtype
    for name, dt in (("xg", xg.dtype), ("out_dtype", out_dtype)):
        if dt not in build.DTYPES:
            raise TypeError(f"moe_ffn_quant: {name} must be fp32/bf16, "
                            f"got {dt}")
    wdt = w_up.dtype
    if wdt not in build.WIRE_DTYPES:
        raise TypeError(f"moe_ffn_quant takes fp16/int8 weights, got {wdt}")
    if slot_ids is None:
        raise ValueError("moe_ffn_quant needs slot_ids")
    dev = xg.device
    build.check_tensor("xg", xg, tuple(xg.shape), xg.dtype, dev)
    E, C, d, f, n = _check_weights(xg, w_gate, w_up, w_down, wdt, slot_ids)
    # int8 takes a scale row per used projection; fp16 takes none
    for name, s, width, used in (("s_gate", s_gate, f, w_gate is not None),
                                 ("s_up", s_up, f, True),
                                 ("s_down", s_down, d, True)):
        if wdt == torch.int8 and used:
            if s is None:
                raise ValueError(f"int8 weights need {name}")
            build.check_tensor(name, s, (n, width), torch.float32, dev)
        elif s is not None:
            raise ValueError(f"{name} is taken only with int8 weights")
    flags = torch.empty((E * C,), dtype=torch.int32, device=dev)
    h = torch.empty((E, C, f), dtype=torch.float32, device=dev)
    y = torch.empty((E, C, d), dtype=out_dtype, device=dev)
    fn = build.load("moe_ffn_quant")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xg.data_ptr(), _ptr(w_gate), w_up.data_ptr(),
                 w_down.data_ptr(), _ptr(s_gate), _ptr(s_up), _ptr(s_down),
                 slot_ids.data_ptr(), flags.data_ptr(), h.data_ptr(),
                 y.data_ptr(),
                 E, C, d, f, ACTS[act], build.DTYPES[xg.dtype],
                 build.WIRE_DTYPES[wdt], build.DTYPES[out_dtype], stream)
    build.check("moe_ffn_quant", err)
    quant_launches += 1
    return y


def _shard_blocks(xg, mesh):
    """-> (xg zero-padded along C to a multiple of D, C, [(device, expert
    slice)] per shard), after checking that D divides E."""
    D = int(mesh.shape["expert"])
    E, C, _ = xg.shape
    if E % D != 0:
        raise ValueError(f"n_experts {E} must divide by the expert-parallel "
                         f"degree {D}")
    Cp = -(-C // D) * D
    if Cp != C:
        xg = torch.nn.functional.pad(xg, (0, 0, 0, Cp - C))
    Eb = E // D
    return xg, C, [(dev, slice(i * Eb, (i + 1) * Eb))
                   for i, dev in enumerate(mesh.devices)]


def _gather_blocks(xg, C, blocks):
    """The shards' (E/D, Cp, d) results back on ``xg``'s device, in expert
    order, the pad rows dropped."""
    y = torch.cat([b.to(xg.device, non_blocking=True) for b in blocks])
    return y[:, :C] if y.shape[1] != C else y


def moe_ffn_sharded(xg, w_gate, w_up, w_down, *, mesh, act: str = "swiglu"):
    """Expert-parallel grouped FFN over an ``ExpertMesh``
    (``launch.mesh``): the reference's ``moe_ffn_sharded``.

    xg: (E, C, d) dispatched token blocks; w_*: (E, d, f) / (E, f, d)
    expert weights, shard i holding experts [i E/D, (i+1) E/D). C is
    zero-padded to a multiple of D (a zero row gives a zero row and
    touches no other row). Each shard's (E/D, Cp, d) token block and
    (E/D, ...) weight blocks are copied to its device (no copy when it is
    xg's), the grouped FFN runs there (``ops.moe_expert_ffn``: B1 on CUDA,
    the plain version on the CPU), and the results come back to xg's
    device in expert order. The reference exchanges C-sharded token blocks
    with two tiled all-to-alls; over a replicated input that is this exact
    permutation, and no contraction dim is split, so every D gives the
    D = 1 result bit for bit. -> (E, C, d). Raises ``ValueError`` when D
    does not divide E."""
    from repro_torch.kernels import ops
    xg, C, shards = _shard_blocks(xg, mesh)
    out = []
    for dev, sl in shards:
        ws = [None if w is None else w[sl].to(dev, non_blocking=True)
              for w in (w_gate, w_up, w_down)]
        out.append(ops.moe_expert_ffn(xg[sl].to(dev, non_blocking=True),
                                      *ws, act=act))
    return _gather_blocks(xg, C, out)


def moe_ffn_sharded_slots(xg, shard_bufs, shard_rows, *, mesh,
                          act: str = "swiglu", out_dtype=None):
    """``moe_ffn_sharded`` over per-shard slot caches: the exchange of the
    expert-parallel serving runtime.

    xg: (E, C, d), position p holding the expert the runtime placed there
    (shard i owns positions [i E/D, (i+1) E/D)); ``shard_bufs[i]``: shard
    i's slot buffers ({w_gate?, w_up, w_down} (n_slots, ...) in the wire
    dtype, plus ``<name>_scale`` under int8) on ``mesh.devices[i]``;
    ``shard_rows[i]``: its (E/D,) int32 position -> slot row, on that
    device. Each shard runs ``ops.moe_expert_ffn_slots`` on its own
    buffers: B2 over fp16/int8, B1 through the slot table over the master
    dtype. -> (E, C, d) in ``out_dtype`` (default xg's), on xg's device.

    The reference gathers each device's experts, dequantized to fp32, and
    then runs ``moe_ffn_sharded(impl="jnp")`` on them. At full width that
    is 64 x 3 x 4096 x 1536 x 4 B, ~4.8 GB of fp32 a shard and layer, so
    the port keeps the weights in their slots and dequantizes inside the
    kernel, as its single-device path does (``ops.moe_expert_ffn_slots``).
    The function is the same: every shard's rows equal the unsharded slot
    FFN's bit for bit."""
    from repro_torch.kernels import ops
    xg, C, shards = _shard_blocks(xg, mesh)
    if not len(shard_bufs) == len(shard_rows) == len(shards):
        raise ValueError(f"{len(shards)} shards, {len(shard_bufs)} buffer "
                         f"sets, {len(shard_rows)} rows")
    out = [ops.moe_expert_ffn_slots(xg[sl].to(dev, non_blocking=True), bufs,
                                    rows, act=act, out_dtype=out_dtype)
           for (dev, sl), bufs, rows in zip(shards, shard_bufs, shard_rows)]
    return _gather_blocks(xg, C, out)


# gelu's tanh approximation: 0.5 z (1 + tanh(GELU_C (z + GELU_A z^3)))
GELU_C, GELU_A = math.sqrt(2.0 / math.pi), 0.044715


def _act_grad(act: str, z):
    """-> (a(z), a'(z)) in fp32 for the activation applied to the gate
    (gated) or up (plain) pre-activation ``z`` (fp32)."""
    if act == "swiglu":
        s = torch.sigmoid(z)
        return z * s, s * (1.0 + z * (1.0 - s))
    if act in ("geglu", "gelu"):
        t = torch.tanh(GELU_C * (z + GELU_A * z * z * z))
        return (0.5 * z * (1.0 + t),
                0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * GELU_C
                * (1.0 + 3.0 * GELU_A * z * z))
    r = torch.relu(z)                                        # relu2
    return r * r, 2.0 * r


def moe_ffn_backward(xg, w_gate, w_up, w_down, dy, *, act: str = "swiglu"):
    """Gradients of ``y = act(xg·W_gate, xg·W_up)·W_down`` per expert for
    the upstream gradient ``dy`` (E, C, d): -> (dxg, dW_gate or None,
    dW_up, dW_down) in the inputs' dtypes.

    Recomputes the gate and up pre-activations (batched products in the
    inputs' dtype, fp32 accumulation), takes the activation's value and
    derivative in fp32, rounds h to the input dtype as the forward does,
    then ``dW_down = hᵀ·dy``, ``dh = dy·W_downᵀ``, ``dW_gate = xgᵀ·dgate``,
    ``dW_up = xgᵀ·dup`` and ``dxg = dgate·W_gateᵀ + dup·W_upᵀ``. Plain
    tensor code on any device."""
    _check_act(act, w_gate)
    dt = xg.dtype
    up = torch.bmm(xg, w_up).float()
    if w_gate is not None:
        a, da = _act_grad(act, torch.bmm(xg, w_gate).float())
        h = a * up
    else:
        h, da = _act_grad(act, up)
    dw_down = torch.bmm(h.to(dt).transpose(1, 2), dy)
    dh = torch.bmm(dy, w_down.transpose(1, 2)).float()
    xt = xg.transpose(1, 2)
    if w_gate is None:
        d_up = (dh * da).to(dt)
        dw_gate, dxg = None, torch.bmm(d_up, w_up.transpose(1, 2))
    else:
        d_up = (dh * a).to(dt)
        d_gate = (dh * up * da).to(dt)
        dw_gate = torch.bmm(xt, d_gate)
        dxg = torch.baddbmm(torch.bmm(d_gate, w_gate.transpose(1, 2)),
                            d_up, w_up.transpose(1, 2))
    return dxg, dw_gate, torch.bmm(xt, d_up), dw_down


class MoEFFN(torch.autograd.Function):
    """B1 on the autograd graph: the forward is ``moe_ffn``'s launch (the
    same bits; on meta tensors its stand-in, ``kernels.meta``), the
    backward ``moe_ffn_backward``."""

    @staticmethod
    def forward(ctx, xg, w_gate, w_up, w_down, act):
        ctx.act = act
        ctx.save_for_backward(xg, w_gate, w_up, w_down)
        if xg.device.type == "meta":
            return meta.moe_ffn(xg, w_gate, w_up, w_down)
        return moe_ffn(xg, w_gate, w_up, w_down, act=act)

    @staticmethod
    def backward(ctx, dy):
        grads = moe_ffn_backward(*ctx.saved_tensors, dy.contiguous(),
                                 act=ctx.act)
        return (*grads, None)
