"""Shared building blocks: norms, activations, RoPE / M-RoPE, dense FFN,
softcap.

Same arithmetic as ``repro.models.layers``: norms and RoPE compute in fp32
and cast back to the input dtype; RoPE is the split-half form; ``gelu`` is
the tanh approximation (``jax.nn.gelu(approximate=True)``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def apply_norm(x, scale, bias=None, eps: float = 1e-6):
    """RMSNorm (``bias`` None) or LayerNorm over the last dim."""
    xf = x.float()
    if bias is not None:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    else:
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * scale
    return y.to(x.dtype)


def rms_norm_headwise(x, scale, eps: float = 1e-6):
    """Qwen3 qk-norm: RMSNorm over the last (head) dim with a learned scale."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


class Norm(nn.Module):
    """Norm parameters (fp32, like the reference) for RMSNorm/LayerNorm."""

    def __init__(self, kind: str, d: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device),
                                  requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(d, device=device),
                                  requires_grad=False)
                     if kind == "layernorm" else None)

    def forward(self, x):
        return apply_norm(x, self.scale, self.bias)


# ---------------------------------------------------------------------------
# Activations and dense FFN
# ---------------------------------------------------------------------------


def activation(name: str):
    if name == "swiglu":
        return F.silu
    if name in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


class FFN(nn.Module):
    """Dense FFN weights: w_up (d, f), w_down (f, d), w_gate (d, f) when
    the activation is gated."""

    def __init__(self, cfg, d_ff: int, dtype, device):
        super().__init__()
        d = cfg.d_model

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.w_up = param(d, d_ff)
        self.w_down = param(d_ff, d)
        self.stds = {"w_up": d ** -0.5, "w_down": d_ff ** -0.5}
        if is_gated(cfg.act):
            self.w_gate = param(d, d_ff)
            self.stds["w_gate"] = d ** -0.5


def apply_ffn(p, x, act_name: str):
    """Dense FFN; ``p`` holds ``w_up`` (d, f), ``w_down`` (f, d) and, for
    gated activations, ``w_gate`` (d, f)."""
    act = activation(act_name)
    up = x @ p.w_up
    h = act(x @ p.w_gate) * up if is_gated(act_name) else act(up)
    return h @ p.w_down


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0, mrope_sections=()):
    """Rotate ``x`` (B, S, H, hd) by ``positions`` (split-half RoPE).

    ``positions``: (B, S), or (3, B, S) for M-RoPE (Qwen2-VL), whose three
    planes are the temporal / height / width position ids; then
    ``mrope_sections`` splits the half-dim into one section per plane."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                      # (hd/2,)
    if mrope_sections:
        if positions.dim() != 3 or sum(mrope_sections) != hd // 2:
            raise ValueError("M-RoPE needs (3, B, S) positions and sections "
                             f"summing to hd/2 = {hd // 2}")
        plane = torch.cat([torch.full((n,), i, dtype=torch.long,
                                      device=x.device)
                           for i, n in enumerate(mrope_sections)])
        pos = positions.permute(1, 2, 0)[..., plane]           # (B, S, hd/2)
        ang = pos.float() * inv
    else:
        ang = positions.float()[..., None] * inv               # (B, S, hd/2)
    cos = torch.cos(ang)[..., None, :]                     # (B, S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)


def softcap(x, cap: float):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
