"""The least time of a decode step and of each kernel launch, from shapes.

The yardstick of the benchmark's roofline shares: bytes at the HBM rate
and operations at the bf16 tensor-core peak of ``frozen/bounds.py``, the
larger of the two. Each counts only what the inputs require, so a share
reads the same whatever implements the work, and never passes 100 % unless
the time leaves out work.
"""
from __future__ import annotations

from perfbench.frozen import bounds
from perfbench.reference.dims import Dims
from perfbench.weights import all_leaves

BF16 = "torch.bfloat16"


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def expert_bytes(D: Dims) -> int:
    esz = 2 if D.dtype in ("bfloat16", "float16") else 4
    return 3 * D.d_model * D.d_expert * esz


def dense_bytes(D: Dims) -> int:
    """Every weight a decode step reads whole: all but the embedding table
    (a step reads its rows) and the routed experts."""
    return sum(lf.nbytes for lf in all_leaves(D)
               if lf.name != "embed" and not lf.routed)


def dense_macs(D: Dims) -> int:
    """Multiply-adds a token spends in the matrices outside the routed
    experts (norm scales and the embedding lookup do none)."""
    return sum(_numel(lf.shape) for lf in all_leaves(D)
               if lf.std and lf.name != "embed" and not lf.routed)


def kv_bytes(D: Dims) -> int:
    """Cache bytes of one position in one layer."""
    esz = 2 if D.dtype in ("bfloat16", "float16") else 4
    if D.mla is not None:
        return (D.mla.kv_lora_rank + D.mla.qk_rope_head_dim) * esz
    return 2 * D.n_kv_heads * D.head_dim * esz


def attn_flops(D: Dims, ctx: int) -> int:
    """One decode token's attention over ``ctx`` cached positions in one
    layer, beyond its projections (MLA: the absorbed form over the
    latent cache)."""
    if D.mla is not None:
        m = D.mla
        return 2 * D.n_heads * ctx * (2 * m.kv_lora_rank
                                      + m.qk_rope_head_dim)
    return 4 * D.n_heads * D.head_dim * ctx


def decode_step_ms(D: Dims, rows: int, distinct, ctx_sum: int) -> float:
    """The least time of one pooled decode step of ``rows`` active rows
    whose caches hold ``ctx_sum`` positions in all (the new one included),
    routing to ``distinct[l]`` experts in MoE layer l."""
    esz = 2 if D.dtype in ("bfloat16", "float16") else 4
    n_moe = len(D.moe_layers)
    nbytes = (dense_bytes(D) + int(sum(distinct)) * expert_bytes(D)
              + D.n_layers * ctx_sum * kv_bytes(D) + rows * D.d_model * esz)
    flops = (2 * rows * (dense_macs(D)
                         + n_moe * D.top_k * 3 * D.d_model * D.d_expert)
             + D.n_layers * attn_flops(D, ctx_sum))
    return bounds.bound(nbytes, flops, BF16)[0]


def b1_ms(E: int, C: int, d: int, f: int, esz: int, counts) -> float:
    """B1's least time for one launch over (E, C, d) blocks, from its
    layer's per-expert routed counts (each clipped at the capacity C)."""
    counts = [min(int(c), C) for c in counts]
    rows = sum(counts)
    experts = sum(1 for c in counts if c > 0)
    return bounds.moe_ffn(E, C, d, f, esz, BF16, rows=rows,
                          experts=experts)[0]


def b3_ms(B: int, H: int, Hkv: int, hd: int, esz: int,
          n_valid: int) -> float:
    """B3's least time for one launch over ``n_valid`` cached positions
    summed over its rows."""
    return bounds.flash_decode(B, H, Hkv, hd, n_valid, esz, BF16)[0]
