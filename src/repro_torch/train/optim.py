"""AdamW as plain functions on tensors, updated in place.

The reference's arithmetic (``repro.train.optim``): clip by the global
norm, fp32 moments, ``u = m̂ / (√v̂ + eps) + wd·p`` on decayed leaves, then
``p ← (p32 − lr·u)`` in p's dtype. Not ``torch.optim.AdamW``: that one
decays ``p`` before the step and decays every parameter unless grouped.

Parameters, gradients and moments are dicts keyed by parameter name
(``dict(model.named_parameters())``). The update walks each tensor in
chunks of ``CHUNK`` elements, so its fp32 temporaries stay small next to
a full-width expert stack.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

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


def adamw_init(params):
    """-> {"mu", "nu": fp32 zeros per parameter, "step": 0}."""
    def zeros(p):
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
    return t.view(-1).split(CHUNK)


def global_norm(tensors):
    """√(Σ x²) over every tensor, in fp32 -> 0-d tensor."""
    total = None
    for t in tensors:
        for c in _chunks(t):
            s = torch.sum(torch.square(c.float()))
            total = s if total is None else total + s
    return torch.sqrt(total)


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
    present = [g for g in grads.values() if g is not None]
    gnorm = global_norm(present)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step
    lr = lr_schedule(cfg, step)
    for name, p in params.items():
        g = grads.get(name)
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
