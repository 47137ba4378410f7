"""Seeded weights of a benchmark configuration, made on the device.

Both sides take their weights from here. The harness fills the program's
parameters in place before it serves; after the window the plain reference
makes the same leaves again, one layer at a time. Every leaf has a
generator of its own, seeded from the run's seed and the leaf's name, so a
leaf can be made again alone, bit for bit, on the same device.

Leaves are named as the program names its parameters and laid out as the
reference reads them (``reference/model.py``): projections (in, out...),
experts (E, in, out). Matrices are normal with std 1/sqrt(fan-in), in the
served dtype; the router is fp32; norm scales are ones.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Tuple

import torch

from perfbench.reference.dims import Dims


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    dtype: str           # torch dtype name
    std: float           # 0: a norm scale of ones
    in_axes: Tuple[int, ...]  # contraction axes (quantization groups)
    routed: bool = False  # a routed expert's weights (E, ...)

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * getattr(torch, self.dtype).itemsize


def leaf_seed(seed: int, name: str) -> int:
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def _ffn(prefix: str, d: int, f: int, dt: str) -> List[Leaf]:
    return [Leaf(f"{prefix}.w_gate", (d, f), dt, d ** -0.5, (0,)),
            Leaf(f"{prefix}.w_up", (d, f), dt, d ** -0.5, (0,)),
            Leaf(f"{prefix}.w_down", (f, d), dt, f ** -0.5, (0,))]


def layer_leaves(D: Dims, i: int) -> List[Leaf]:
    d, H, dt, f32 = D.d_model, D.n_heads, D.dtype, "float32"
    p = f"layers.{i}"
    out = [Leaf(f"{p}.norm1.scale", (d,), f32, 0.0, (0,)),
           Leaf(f"{p}.norm2.scale", (d,), f32, 0.0, (0,))]
    if D.mla is not None:
        m = D.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        out += [
            Leaf(f"{p}.attn.w_dq", (d, m.q_lora_rank), dt, d ** -0.5,
                 (0,)),
            Leaf(f"{p}.attn.w_uq", (m.q_lora_rank, H, qk), dt,
                 m.q_lora_rank ** -0.5, (0,)),
            Leaf(f"{p}.attn.w_dkv", (d, m.kv_lora_rank), dt, d ** -0.5,
                 (0,)),
            Leaf(f"{p}.attn.w_kr", (d, m.qk_rope_head_dim), dt, d ** -0.5,
                 (0,)),
            Leaf(f"{p}.attn.w_uk", (m.kv_lora_rank, H, m.qk_nope_head_dim),
                 dt, m.kv_lora_rank ** -0.5, (0,)),
            Leaf(f"{p}.attn.w_uv", (m.kv_lora_rank, H, m.v_head_dim), dt,
                 m.kv_lora_rank ** -0.5, (0,)),
            Leaf(f"{p}.attn.w_o", (H, m.v_head_dim, d), dt,
                 (H * m.v_head_dim) ** -0.5, (0, 1)),
            Leaf(f"{p}.attn.q_norm_scale", (m.q_lora_rank,), f32, 0.0,
                 (0,)),
            Leaf(f"{p}.attn.kv_norm_scale", (m.kv_lora_rank,), f32, 0.0,
                 (0,))]
    else:
        hd, Hkv = D.head_dim, D.n_kv_heads
        out += [Leaf(f"{p}.attn.w_q", (d, H, hd), dt, d ** -0.5, (0,)),
                Leaf(f"{p}.attn.w_k", (d, Hkv, hd), dt, d ** -0.5, (0,)),
                Leaf(f"{p}.attn.w_v", (d, Hkv, hd), dt, d ** -0.5, (0,)),
                Leaf(f"{p}.attn.w_o", (H, hd, d), dt, (H * hd) ** -0.5,
                     (0, 1))]
        if D.qk_norm:
            out += [Leaf(f"{p}.attn.q_norm_scale", (hd,), f32, 0.0, (0,)),
                    Leaf(f"{p}.attn.k_norm_scale", (hd,), f32, 0.0, (0,))]
    if not D.is_moe(i):
        return out + _ffn(f"{p}.ffn", d, D.d_ff_dense, dt)
    E, f = D.n_experts, D.d_expert
    out += [Leaf(f"{p}.moe.w_router", (d, E), f32, d ** -0.5, (0,)),
            Leaf(f"{p}.moe.w_gate", (E, d, f), dt, d ** -0.5, (1,), True),
            Leaf(f"{p}.moe.w_up", (E, d, f), dt, d ** -0.5, (1,), True),
            Leaf(f"{p}.moe.w_down", (E, f, d), dt, f ** -0.5, (1,), True)]
    if D.n_shared:
        out += _ffn(f"{p}.moe.shared", d, D.n_shared * f, dt)
    return out


def top_leaves(D: Dims) -> List[Leaf]:
    d, dt = D.d_model, D.dtype
    return [Leaf("embed", (D.vocab, d), dt, d ** -0.5, (1,)),
            Leaf("lm_head", (d, D.vocab), dt, d ** -0.5, (0,)),
            Leaf("final_norm.scale", (d,), "float32", 0.0, (0,))]


def all_leaves(D: Dims) -> List[Leaf]:
    out = top_leaves(D)
    for i in range(D.n_layers):
        out += layer_leaves(D, i)
    return out


@torch.no_grad()
def fill_(t: torch.Tensor, leaf: Leaf, seed: int) -> torch.Tensor:
    """Write ``leaf``'s values for ``seed`` into ``t`` (its shape and dtype,
    contiguous) in place, on ``t``'s device."""
    if leaf.std == 0.0:
        return t.fill_(1.0)
    g = torch.Generator(device=t.device)
    g.manual_seed(leaf_seed(seed, leaf.name))
    return t.normal_(0.0, leaf.std, generator=g)


def make(leaf: Leaf, seed: int, device) -> torch.Tensor:
    t = torch.empty(leaf.shape, dtype=getattr(torch, leaf.dtype),
                    device=device)
    return fill_(t, leaf, seed)


@torch.no_grad()
def fill_params(params: dict, D: Dims, seed: int) -> None:
    """Fill ``params`` ({name: tensor}, the program's parameters) with the
    configuration's leaves, in place. Every leaf must match one parameter
    in name, shape and dtype, and every parameter one leaf."""
    leaves = {lf.name: lf for lf in all_leaves(D)}
    if set(leaves) != set(params):
        raise ValueError(
            "the program's parameters differ from the configuration's "
            f"leaves: only the program's {sorted(set(params) - set(leaves))}"
            f", only the leaves' {sorted(set(leaves) - set(params))}")
    for name, t in params.items():
        lf = leaves[name]
        if tuple(t.shape) != lf.shape or t.dtype != getattr(torch, lf.dtype) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: the program's {tuple(t.shape)} "
                             f"{t.dtype}, the leaf's {lf.shape} {lf.dtype}")
        fill_(t, lf, seed)
