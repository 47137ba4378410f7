"""AdamW as plain functions on tensors, updated in place.

The reference's arithmetic (``repro.train.optim``): clip by the global
norm, fp32 moments, ``u = m̂ / (√v̂ + eps) + wd·p`` on decayed leaves, then
``p ← (p32 − lr·u)`` in p's dtype. Not ``torch.optim.AdamW``: that one
decays ``p`` before the step and decays every parameter unless grouped.

Parameters, gradients and moments are dicts keyed by parameter name
(``dict(model.named_parameters())``). The update walks each tensor in
chunks of ``CHUNK`` elements, so its fp32 temporaries stay small next to
a full-width expert stack.

On a placed model (``launch/sharding.py::place``) the parameters are
DTensors: each gradient is first laid out as its parameter is, the
moments are the local blocks' and each rank updates its own blocks. The
global norm sums each element once: squares over local blocks, summed
over the mesh dims a parameter is sharded on (an all-reduce on the
device, no host sync); a replicated parameter counts once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor

CHUNK = 1 << 26          # elements per in-place pass (256 MB of fp32)


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def _local(t):
    """A DTensor's local block (its storage: updated in place), a plain
    tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def adamw_init(params):
    """-> {"mu", "nu": fp32 zeros per parameter (per local block of a
    DTensor), "step": 0}."""
    def zeros(p):
        p = _local(p)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"mu": {n: zeros(p) for n, p in params.items()},
            "nu": {n: zeros(p) for n, p in params.items()},
            "step": 0}


def lr_schedule(cfg: OptConfig, step: int) -> float:
    """Linear warmup to ``lr``, then a cosine down to 0.1 × ``lr``."""
    warm = min(1.0, (step + 1) / max(1, cfg.warmup_steps))
    prog = min(max((step - cfg.warmup_steps)
                   / max(1, cfg.total_steps - cfg.warmup_steps), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _chunks(t):
    return t.reshape(-1).split(CHUNK)


def global_norm(tensors):
    """√(Σ x²) over every tensor, in fp32 -> 0-d tensor. A DTensor (laid
    out by Shard or Replicate) counts each element once: its local squares
    are summed over the mesh dims it is sharded on; unplaced tensors, and
    DTensors sharded on no dim of more than one rank, sum in one running
    total, in order."""
    totals, meshes = {}, {}
    for t in tensors:
        key = ()
        if isinstance(t, DTensor):
            mesh = t.device_mesh
            if any(p.is_partial() for p in t.placements):
                raise ValueError("global_norm: a partial DTensor; lay it "
                                 "out as its parameter first")
            key = tuple(i for i, p in enumerate(t.placements)
                        if p.is_shard() and mesh.size(i) > 1)
            meshes[key] = mesh
            t = t.to_local()
        for c in _chunks(t):
            s = torch.sum(torch.square(c.float()))
            totals[key] = s if key not in totals else totals[key] + s
    total = None
    for key, s in totals.items():
        for dim in key:
            s = funcol.all_reduce(s, "sum", (meshes[key], dim))
        total = s if total is None else total + s
    return torch.sqrt(total)


def laid_out_as(g, p):
    """Gradient ``g`` in parameter ``p``'s placements (a DTensor gradient
    comes in whatever layout the backward left it)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def decay_mask(model):
    """Which parameters AdamW decays: the reference decays a leaf of ndim
    >= 2. It stacks every layer of the periodic tail (``blocks``) and of
    the encoder on a leading axis, so there a norm scale or bias is 2-D
    and decays, while in a ``prefix`` layer or at the top it does not. The
    port unstacks layers, so each parameter takes the reference leaf's
    ndim. -> {name: bool}."""
    def stacked(name):
        parts = name.split(".")
        return parts[0] == "encoder" or (
            parts[0] == "layers" and int(parts[1]) >= model.n_prefix)
    return {n: p.dim() + stacked(n) >= 2
            for n, p in model.named_parameters()}


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, state, decay):
    """One AdamW step, in place on ``params`` and ``state``. ``grads``: a
    gradient per name (None counts as zeros, as a leaf the loss does not
    reach has a zero gradient in the reference). ``decay``: {name: bool},
    which parameters decay (``decay_mask`` for a model's). -> the global
    gradient norm before clipping (0-d fp32 tensor)."""
    state["step"] += 1
    step = state["step"]
    grads = {n: laid_out_as(g, params[n]) for n, g in grads.items()
             if g is not None}
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step
    lr = lr_schedule(cfg, step)
    for name, p in params.items():
        p, g = _local(p), grads.get(name)
        g = None if g is None else _local(g)
        wd = cfg.weight_decay if decay[name] else 0.0
        mu, nu = state["mu"][name], state["nu"][name]
        gcs = _chunks(g) if g is not None else [None] * len(_chunks(p))
        for pc, gc, m, v in zip(_chunks(p), gcs, _chunks(mu), _chunks(nu)):
            m.mul_(cfg.b1)
            v.mul_(cfg.b2)
            if gc is not None:
                g32 = gc.float() * scale
                m.add_(g32, alpha=1 - cfg.b1)
                v.addcmul_(g32, g32, value=1 - cfg.b2)
            u = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
            p32 = pc.float()          # pc itself when fp32: updated in place
            if wd:
                u.add_(p32, alpha=wd)
            pc.copy_(p32.sub_(u, alpha=lr))
    return gnorm
