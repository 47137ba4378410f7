"""Routed mixture-of-experts FFN (global or per-sequence sort+gather
dispatch).

The dispatch is the reference's step for step (``repro.models.moe``): a
stable argsort of the (token, expert) assignments by expert, capacity
clipping, a scatter of token indices into ``(E*C)`` slots whose
over-capacity entries land in one extra row that is sliced off (the
reference's ``mode="drop"``), a gather into ``(E, C, d)`` blocks, the
grouped expert FFN (the hand-written kernel on CUDA; over the device slot
cache's buffers on the streaming path), and a gate-weighted ``index_add_``
back to tokens, accumulated in fp32 at least. Pad tokens route to the
sentinel expert ``E``. ``moe_dispatch="grouped"`` does the same per sequence
(``moe_ffn_grouped``). The per-sequence counts (the paper's EAM rows)
equal the reference's exactly: they feed the shared numpy host policy.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ArchConfig, MoEConfig
from repro_torch.kernels import ops
from repro_torch.launch import spmd
from repro_torch.models.layers import FFN, apply_ffn, is_gated


class MoE(nn.Module):
    """Router (fp32, (d, E)) and stacked expert weights in the reference
    layout: w_gate/w_up (E, d, f), w_down (E, f, d)."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        m, d = cfg.moe, cfg.d_model
        E, f = m.n_experts, m.d_expert

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.w_router = param(d, E, dt=torch.float32)
        self.w_up = param(E, d, f)
        self.w_down = param(E, f, d)
        self.stds = {"w_router": d ** -0.5, "w_up": d ** -0.5,
                     "w_down": f ** -0.5}
        if is_gated(cfg.act):
            self.w_gate = param(E, d, f)
            self.stds["w_gate"] = d ** -0.5
        if m.n_shared_experts:
            d_sh = (m.d_shared or m.d_expert) * m.n_shared_experts
            self.shared = FFN(cfg, d_sh, dtype, device)


def capacity(T: int, m: MoEConfig, factor: float | None = None) -> int:
    f = m.capacity_factor if factor is None else factor
    c = int(T * m.top_k / m.n_experts * f) + 1
    return max(m.top_k, min(c, T))


def _traced_capacity(n_tokens, m: MoEConfig, factor: float | None):
    """``capacity`` over a token count held in a tensor (same formula, in
    fp32 like the reference), so it stays on the device."""
    f = m.capacity_factor if factor is None else factor
    c = torch.floor(n_tokens * m.top_k / m.n_experts * f).to(torch.int32) + 1
    return torch.clamp(torch.minimum(c, n_tokens.to(torch.int32)),
                       min=m.top_k)


def route(p, m: MoEConfig, xf):
    """xf (T, d) -> (gates (T,k), idx (T,k), probs (T,E))."""
    logits = xf.float() @ p.w_router
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, m.top_k, dim=-1)
    if m.router_norm_topk:
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    return gates, idx, probs


def _aux(m: MoEConfig, idx, probs, token_mask):
    """{"counts": (B, E) int32 per-sequence expert counts (the EAM rows;
    masked tokens add nothing), "aux_loss": the load-balance loss, 0 when
    routing came precomputed (``probs`` None)} from idx (B, S·k)."""
    B, Sk = idx.shape
    E = m.n_experts
    one_hot = F.one_hot(idx, E).to(torch.int32)
    if token_mask is not None:
        one_hot = one_hot * token_mask.to(torch.int32) \
            .repeat_interleave(m.top_k, dim=1)[..., None]
    counts = one_hot.sum(dim=1, dtype=torch.int32)
    if probs is None:
        aux_loss = torch.zeros((), device=idx.device)
    else:
        frac_tokens = counts.sum(dim=0).float() / (B * Sk)
        frac_probs = probs.mean(dim=0)
        aux_loss = m.aux_loss_coef * E * torch.sum(frac_tokens * frac_probs)
    return {"counts": counts, "aux_loss": aux_loss}


def _acc_dtype(dtype):
    """The combine's accumulator: fp32 at least. A token's k bf16
    contributions then sum exactly unless their magnitudes span more than
    ~2^16, so CUDA's atomic ``index_add_`` gives the same bits whatever
    order its adds land in (a bf16 accumulator rounds at every add, in that
    order); fp32 inputs are unchanged."""
    return torch.promote_types(dtype, torch.float32)


def slot_out_dtype(x_dtype, slot_weights):
    """The expert output dtype of the reference's slot path: its gather
    widens fp16/int8 wires to fp32 weights (a master-dtype wire stays as
    it is), and the grouped einsum promotes x against them, so bf16 x over
    a narrow wire stays fp32 until after the combine."""
    w = slot_weights["w_up"]
    narrow = "w_up_scale" in slot_weights or w.dtype == torch.float16
    return torch.promote_types(x_dtype, torch.float32 if narrow else w.dtype)


def _slots(m: MoEConfig, idx, T: int, C: int, token_mask, capacity_factor):
    """Capacity dispatch of the (T, k) routed experts ``idx``: -> (order,
    the stable sort of the (token, expert) pairs by expert; slot_idx, each
    sorted pair's slot in ``E*C`` (over-capacity pairs at the extra slot
    E*C); slot_token, the token feeding each of the E*C + 1 slots, T for
    none: the last slot is the over-capacity row, which callers slice
    off)."""
    E, k = m.n_experts, m.top_k
    dev = idx.device
    flat_e = idx.reshape(T * k)
    C_drop = C
    if token_mask is not None:
        # pad tokens route to sentinel expert E: they sort past every real
        # segment and never take a capacity slot ahead of a real token
        real = token_mask.reshape(T).repeat_interleave(k)
        flat_e = torch.where(real, flat_e, torch.full_like(flat_e, E))
        # drop exactly as an exact-length prefill would
        C_drop = _traced_capacity(token_mask.sum(), m, capacity_factor)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]                                 # (T*k,)
    token_of = order // k
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(E, device=dev, dtype=sorted_e.dtype),
        side="left")
    e_clip = torch.clamp(sorted_e, max=E - 1)
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[e_clip]
    keep = (pos_in_e < C_drop) & (sorted_e < E)
    slot = e_clip * C + torch.clamp(pos_in_e, max=C - 1)

    # token feeding each of the E*C slots (T = "no token"); over-capacity
    # entries scatter to the extra row E*C
    slot_idx = torch.where(keep, slot, torch.full_like(slot, E * C))
    slot_token = torch.full((E * C + 1,), T, dtype=torch.long, device=dev)
    slot_token[slot_idx] = token_of
    return order, slot_idx, slot_token


def _global(m: MoEConfig, C: int, capacity_factor, e0: int, El: int, ffn,
            xf, gates, idx, token_mask):
    """The global dispatch over experts e0 .. e0 + El - 1: xf (T, d) with
    its routing gates/idx (T, k) and ``token_mask`` (B, S) (or None). The
    dispatch runs over all T tokens and all E experts (the capacity is
    global); only the local experts' slots are gathered into (El, C, d)
    blocks, run through ``ffn`` (-> (El, C, d)), gate-weighted and summed
    back to their tokens. -> (T, d) in the accumulator dtype: this rank's
    share of y (all of it when every expert is local)."""
    T, d = xf.shape
    E = m.n_experts
    order, slot_idx, slot_token = _slots(m, idx, T, C, token_mask,
                                         capacity_factor)
    local = slice(e0 * C, (e0 + El) * C)
    slot_token = slot_token[local]
    x_pad = torch.cat([xf, xf.new_zeros(1, d)], dim=0)
    yg = ffn(x_pad[slot_token].reshape(El, C, d)).reshape(El * C, d)
    gate_flat = gates.reshape(-1)[order]
    slot_gate = torch.zeros(E * C + 1, dtype=gates.dtype, device=xf.device)
    slot_gate[slot_idx] = gate_flat
    contrib = yg * slot_gate[local, None].to(yg.dtype)
    acc = _acc_dtype(contrib.dtype)
    y = torch.zeros(T + 1, d, dtype=acc, device=xf.device)
    y.index_add_(0, slot_token, contrib.to(acc))
    return y[:T]


def moe_ffn(p, cfg: ArchConfig, x, *, capacity_factor: float | None = None,
            expert_fn=None, token_mask=None, routing=None, slot_weights=None,
            slot_ids=None):
    """Apply the routed MoE to x (B, S, d).

    Returns (y, aux) with aux = {"counts": (B, E) int32 per-sequence expert
    activation counts, "aux_loss": load-balance loss}. ``expert_fn``:
    optional ``(xg (E, C, d), p) -> (E, C, d)`` that replaces the grouped
    expert FFN (the expert-parallel runtime's sharded FFN). ``token_mask``:
    optional (B, S) bool validity mask; masked tokens take no expert
    capacity and add nothing to ``counts``. ``routing``: optional
    precomputed (gates (T,k), idx (T,k)) from :func:`route` over the
    flattened tokens (the slot runtime routes first so that the host can
    upload the routed experts before the expert FFN runs); ``aux_loss`` is
    0 then. ``slot_weights``/``slot_ids``: the expert weights are the
    device slot cache's buffers and (E,) int32 expert -> slot table
    (``ops.moe_expert_ffn_slots``) instead of ``p``'s. Under
    ``cfg.moe_dispatch == "grouped"`` a batch of more than one sequence
    takes ``moe_ffn_grouped``.

    Over ``p``'s own experts the dispatch is one site over the local
    blocks (``_global``), as GSPMD partitions the reference's: on a placed
    model every rank sorts all T tokens (replicated over every mesh axis),
    each model rank runs B1 over its own experts' blocks, (E/m, C, d), and
    combines only their slots, so the output is a partial sum over the
    model axis, reduced there in the accumulator dtype; nothing of size
    E·C·d crosses a link. The input's and the gates' gradients are partial
    over the model axis; the experts' are whole on every data rank, which
    sees every row. ``expert_fn`` and ``slot_weights`` run unplaced (the
    expert-parallel and streaming runtimes): on a placed model they
    raise."""
    if cfg.moe_dispatch == "grouped" and x.shape[0] > 1:
        if slot_weights is not None:
            raise NotImplementedError(
                "grouped dispatch over slot-cache weights: the streaming "
                "runtime requires global dispatch")
        return moe_ffn_grouped(p, cfg, x, capacity_factor=capacity_factor,
                               expert_fn=expert_fn, token_mask=token_mask,
                               routing=routing)
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    if routing is None:
        gates, idx, probs = route(p, m, xf)        # (T,k) (T,k) (T,E)
    else:
        (gates, idx), probs = routing, None
    C = capacity(T, m, capacity_factor)
    # the routing decisions are integers off the autograd graph: on a
    # placed model each rank sorts its replicated copy (DTensor has no rule
    # for argsort or searchsorted)
    idx = spmd.local(idx)
    if expert_fn is None and slot_weights is None:
        e0 = spmd.offset(p.w_up, 0)             # this rank's first expert

        def fn(xf, gates, idx, token_mask, w_gate, w_up, w_down):
            def ffn(xg):
                return ops.moe_expert_ffn(xg, w_gate, w_up, w_down,
                                          act=cfg.act)
            return _global(m, C, capacity_factor, e0, w_up.shape[0], ffn,
                           xf, gates, idx, token_mask)
        experts = (0, None)
        y = spmd.site(fn, (None, None, None, None, experts, experts,
                           experts), (("partial", None),), xf, gates, idx,
                      token_mask, getattr(p, "w_gate", None), p.w_up,
                      p.w_down,
                      grad_specs=(("partial", None), ("partial", None),
                                  None, None, experts, experts, experts))
        y = spmd.reduced(y)
    else:
        if spmd.is_placed(x, getattr(p, "w_up", None)):
            what = ("an expert_fn" if expert_fn is not None
                    else "slot-cache weights")
            raise NotImplementedError(
                f"global dispatch with {what} on a placed model: the "
                "expert-parallel and streaming runtimes run unplaced")
        if expert_fn is not None:
            def ffn(xg):
                return expert_fn(xg, p)
        else:
            def ffn(xg):
                return ops.moe_expert_ffn_slots(
                    xg, slot_weights, slot_ids, act=cfg.act,
                    out_dtype=slot_out_dtype(x.dtype, slot_weights))
        y = _global(m, C, capacity_factor, 0, m.n_experts, ffn, xf, gates,
                    idx, token_mask)
    y = y.reshape(B, S, d).to(x.dtype)

    if m.n_shared_experts:
        y = y + apply_ffn(p.shared, x, cfg.act)

    return y, _aux(m, idx.reshape(B, S * m.top_k), probs, token_mask)


def moe_ffn_grouped(p, cfg: ArchConfig, x, *,
                    capacity_factor: float | None = None, expert_fn=None,
                    token_mask=None, routing=None):
    """Per-sequence dispatch (GShard grouping, one group per sequence):
    the reference's ``moe_ffn_grouped``. Each row of x (B, S, d) sorts,
    clips at its own capacity C = capacity(S) and fills its own (E, C, d)
    blocks; ``token_mask`` rows drop at their own real token count's
    capacity. The experts' weights are shared across rows, so the (B, E,
    C, d) blocks go through the grouped expert FFN as one (E, B·C, d)
    call (B1 on CUDA) and come back: the reference's ``becd,edf->becf``
    chain. ``expert_fn`` (see ``moe_ffn``) is called once a sequence on
    its (E, C, d) blocks, as the reference ``vmap``s it. Returns (y, aux)
    as ``moe_ffn`` does.

    On a placed model the blocks lie as the reference's
    ``set_dispatch_constraint(P(batch, "model", None, None))`` lays them,
    read from the placements of x and of the experts' weights: a site over
    the local blocks (``_grouped``) in which each data rank dispatches its
    own rows (groups), each model rank runs B1 over its own experts' blocks
    at (E/m, (B/dp)·C, d) and gathers back only their contributions, so
    the output is a partial sum over the model axis, reduced there (in the
    accumulator dtype). The input's and the gates' gradients are partial
    over the model axis, the experts' over the batch axes. A batch that
    does not split over the data axis replicates its groups. ``expert_fn``
    on a placed model raises, as the reference's expert-parallel runtime
    refuses grouped dispatch."""
    m = cfg.moe
    B, S, d = x.shape
    if expert_fn is not None and spmd.is_placed(p.w_up):
        raise NotImplementedError(
            "grouped dispatch with an expert_fn on a placed model: the "
            "expert-parallel runtime requires global dispatch")
    if routing is None:
        gates, idx, probs = route(p, m, x.reshape(B * S, d))
    else:
        (gates, idx), probs = routing, None
    C = capacity(S, m, capacity_factor)
    e0 = spmd.offset(p.w_up, 0)             # this rank's first expert

    def fn(x, gates, idx, token_mask, w_gate, w_up, w_down):
        return _grouped(m, cfg.act, C, capacity_factor, expert_fn, p, e0,
                        x, gates, idx, token_mask, w_gate, w_up, w_down)
    rows, experts = (None, 0), (0, None)
    y = spmd.site(fn, (rows, rows, rows, rows, experts, experts, experts),
                  (("partial", 0),), x, gates, idx, token_mask,
                  getattr(p, "w_gate", None), p.w_up, p.w_down,
                  grad_specs=(("partial", 0), ("partial", 0), rows, rows,
                              (0, "partial"), (0, "partial"),
                              (0, "partial")))
    y = spmd.reduced(y).to(x.dtype)

    if m.n_shared_experts:
        y = y + apply_ffn(p.shared, x, cfg.act)

    return y, _aux(m, spmd.local(idx).reshape(B, S * m.top_k), probs,
                   token_mask)


class _Take(torch.autograd.Function):
    """x (B, S, d) at rows ``idx`` (B, n) -> (B, n, d): ``torch.gather``
    along dim 1, whose backward sums each row's copies (a token's k routed
    slots) in the accumulator dtype: fp32 sums of a few bf16 values are
    exact, so CUDA's atomic scatter-add gives the same bits in whatever
    order its adds land (``_acc_dtype``'s argument for the combine), and
    the input's gradient is the same placed or not, run after run."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.dtype = x.shape, x.dtype
        return torch.gather(x, 1, idx[..., None].expand(*idx.shape,
                                                          x.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        acc = torch.zeros(ctx.shape, dtype=_acc_dtype(ctx.dtype),
                          device=g.device)
        acc.scatter_add_(1, idx[..., None].expand(*idx.shape, g.shape[-1]),
                         g.to(acc.dtype))
        return acc.to(ctx.dtype), None


def _grouped(m: MoEConfig, act: str, C: int, capacity_factor, expert_fn, p,
             e0: int, x, gates, idx, token_mask, w_gate, w_up, w_down):
    """``moe_ffn_grouped`` over one rank's blocks: its rows x (B, S, d)
    with their routing gates/idx (B·S, k) and ``token_mask`` (B, S) (or
    None), and its experts e0 .. e0 + E_l - 1 (``w_up``'s E_l). Every
    row's dispatch runs over all E experts; only the local experts' slots
    are gathered, run through the grouped expert FFN as one (E_l, B·C, d)
    call and combined. -> this rank's share of y (B, S, d) in the
    accumulator dtype (all of it when the experts are all local)."""
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    El = w_up.shape[0]
    dev = x.device
    flat_e = idx.reshape(B, S * k)
    C_drop = C
    if token_mask is not None:
        # sentinel expert E: pads sort last and take no capacity; each row
        # drops at its own real token count's capacity
        real = token_mask.repeat_interleave(k, dim=1)
        flat_e = torch.where(real, flat_e, torch.full_like(flat_e, E))
        C_drop = _traced_capacity(token_mask.sum(dim=1), m,
                                  capacity_factor)[:, None]
    order = torch.argsort(flat_e, dim=-1, stable=True)          # (B, S·k)
    sorted_e = torch.gather(flat_e, 1, order)
    token_of = order // k
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(E, device=dev, dtype=sorted_e.dtype)
        .expand(B, E).contiguous(), side="left")                # (B, E)
    e_clip = torch.clamp(sorted_e, max=E - 1)
    pos_in_e = torch.arange(S * k, device=dev) - torch.gather(
        seg_start, 1, e_clip)
    keep = (pos_in_e < C_drop) & (sorted_e < E)
    slot = e_clip * C + torch.clamp(pos_in_e, max=C - 1)
    # one flat row of E*C + 1 slots per sequence; over-capacity entries
    # scatter to each row's extra slot, which is sliced off
    row = torch.arange(B, device=dev)[:, None] * (E * C + 1)
    slot_idx = row + torch.where(keep, slot, torch.full_like(slot, E * C))
    slot_token = torch.full((B, E * C + 1), S, dtype=torch.long, device=dev)
    slot_token.view(-1)[slot_idx.reshape(-1)] = token_of.reshape(-1)
    # this rank's experts' slots
    local = slice(e0 * C, (e0 + El) * C)
    slot_token = slot_token[:, local]
    x_pad = torch.cat([x, x.new_zeros(B, 1, d)], dim=1)
    xg = _Take.apply(x_pad, slot_token)

    if expert_fn is not None:
        yg = torch.stack([expert_fn(g, p) for g in xg.reshape(B, El, C, d)])
        yg = yg.reshape(B, El * C, d)
    else:
        # (B, E_l, C, d) -> (E_l, B·C, d): one grouped FFN over every row's
        # blocks
        xe = xg.reshape(B, El, C, d).transpose(0, 1).reshape(El, B * C, d)
        ye = ops.moe_expert_ffn(xe, w_gate, w_up, w_down, act=act)
        yg = ye.reshape(El, B, C, d).transpose(0, 1).reshape(B, El * C, d)

    gate_flat = torch.gather(gates.reshape(B, S * k), 1, order)
    slot_gate = torch.zeros(B * (E * C + 1), dtype=gates.dtype, device=dev)
    slot_gate[slot_idx.reshape(-1)] = gate_flat.reshape(-1)
    slot_gate = slot_gate.reshape(B, E * C + 1)[:, local]
    contrib = yg * slot_gate[..., None].to(yg.dtype)
    acc = _acc_dtype(contrib.dtype)
    y = torch.zeros(B * (S + 1), d, dtype=acc, device=dev)
    dest = torch.arange(B, device=dev)[:, None] * (S + 1) + slot_token
    y.index_add_(0, dest.reshape(-1), contrib.reshape(B * El * C, d).to(acc))
    return y.reshape(B, S + 1, d)[:, :S]
