"""Frozen copy of the port's kernel bounds.

Copied verbatim from ``src/repro_torch/kernels/bounds.py`` at commit
594f206bf3e0cabed91f0411f45bb1daddd07a9f. The benchmark's yardstick: the
program may change its copy, the benchmark's rooflines read this one.

Original docstring follows.

The least time each of the port's kernels could take on an H100.

One function a kernel, pure arithmetic from shapes, element sizes and the
data-dependent counts of a launch (routed rows, experts with a routed row,
valid cache positions): each returns ``(ms, by)``, the larger of

    bytes the function must move (each input read once, each output
    written once) / HBM_BYTES_PER_S,
    the operations it does on these inputs / PEAK_FLOPS of their type,

and ``by``, "bytes" or "operations", whichever sets it. The backward
kernels also return the same bound over this design's own work (its
checkpoints, partials and recompute), where that differs. ``chip_smoke.py``,
``scripts/kernel_ab.py`` and ``launch/roofline.py`` read the peaks and
bounds from here, so a roofline share reads the same work whatever
implements the kernel. Imports nothing: element sizes are bytes.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # H100 SXM5, HBM3
# H100 SXM5's NVLink 4 from NVIDIA's datasheet (900 GB/s over 18 links,
# both directions counted): one direction, 450 GB/s, into each card. A
# datasheet figure, not a measurement; the dry run's collective term
# (``launch/roofline.py``) divides each device's collective bytes by it.
NVLINK_BYTES_PER_S = 450e9
# dense peaks by the dtype the products run in, keyed as str(torch dtype)
PEAK_FLOPS = {"torch.bfloat16": 989e12,      # tensor cores
              "torch.float32": 67e12}        # CUDA-core FMA
FP32 = "torch.float32"


def bound(nbytes, flops, dtype):
    """-> (ms, "bytes" | "operations") for ``nbytes`` moved and ``flops``
    done in ``dtype`` (a torch dtype or its ``str``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def moe_ffn(E, C, d, f, esz, dtype, *, rows=None, experts=None, n_proj=3):
    """B1, the grouped expert FFN over (E, C, d) rows: xg and y once, the
    ``n_proj`` weights of each of ``experts`` experts with a routed row
    (default every expert), and 2·d·f products a projection for each of
    ``rows`` routed rows (default every row)."""
    rows = E * C if rows is None else rows
    experts = E if experts is None else experts
    return bound(esz * (2 * E * C * d + experts * n_proj * d * f),
                 2 * rows * d * f * n_proj, dtype)


def moe_ffn_backward(E, C, d, f, esz, dtype, *, rows, experts, n_proj=3):
    """B1's backward (swiglu): the function's least traffic, xg, dy and dxg
    once, the weights of each routed expert read once and all E experts'
    dW written once; 8 products over the routed rows (h for dW_down needs
    the gate and up products again). -> (ms, by, design ms): this design
    also reads W_gate and W_up a second time for its recompute of h."""
    w1 = d * f
    flops = 2 * rows * w1 * 8
    ms, by = bound(esz * (3 * E * C * d + experts * n_proj * w1
                          + E * n_proj * w1), flops, dtype)
    design, _ = bound(esz * (3 * E * C * d + experts * (n_proj + 2) * w1
                             + E * n_proj * w1), flops, dtype)
    return ms, by, design


def moe_ffn_quant(E, C, d, f, *, x_esz, w_esz, out_esz, rows, slots_read,
                  n_proj=3, scales=True):
    """B2, the expert FFN over slot buffers through an expert -> slot
    table: xg, y and the (E,) int32 table once, and the weights (with the
    fp32 per-column scales of an int8 wire) of the ``slots_read`` slots
    that experts with a routed row read; the routed rows' products in fp32
    (the dequantizing FMA path). ``rows=0`` gives the bytes term alone."""
    per_slot = n_proj * d * f * w_esz
    if scales:
        per_slot += 4 * ((n_proj - 1) * f + d)
    nbytes = x_esz * E * C * d + slots_read * per_slot + 4 * E \
        + out_esz * E * C * d
    return bound(nbytes, 2 * rows * d * f * n_proj, FP32)


def flash_decode(B, H, Hkv, hd, n_valid, esz, dtype):
    """B3, single-token GQA attention: q and the output once, the K and V
    of the ``n_valid`` valid positions summed over the rows; QKᵀ and PV, 4
    operations a head, dimension and valid position."""
    return bound(esz * (2 * B * H * hd + 2 * n_valid * Hkv * hd),
                 4 * H * hd * n_valid, dtype)


def decode_scores(B, H, Hkv, hd_l, n_valid, esz, dtype):
    """B3-qk, one head_dim slice's partial scores: q's slice once, the K
    slice of the ``n_valid`` valid positions summed over the rows, and
    their fp32 scores written once; q·Kᵀ, 2 operations a head, slice
    dimension and valid position."""
    return bound(esz * (B * H * hd_l + n_valid * Hkv * hd_l)
                 + 4 * H * n_valid, 2 * H * hd_l * n_valid, dtype)


def decode_scores_own(B, H, Hkv, hd_l, S, n_valid, esz, dtype):
    """B3-qk's own least work: ``decode_scores``' q and K, and every one
    of the (B, H, S) fp32 scores written, the zeros past each length
    included (the all-reduce that follows sums the whole buffer)."""
    return bound(esz * (B * H * hd_l + n_valid * Hkv * hd_l)
                 + 4 * B * H * S, 2 * H * hd_l * n_valid, dtype)


def decode_values(B, H, Hkv, hd_l, n_valid, esz, dtype):
    """B3-pv, the softmax of the summed scores over one head_dim slice of
    V: the fp32 scores of the ``n_valid`` valid positions and the V slice
    there read once, the output's slice written once; p·V, 2 operations a
    head, slice dimension and valid position."""
    return bound(4 * H * n_valid + esz * (n_valid * Hkv * hd_l + B * H * hd_l),
                 2 * H * hd_l * n_valid, dtype)


def _wkv6_bytes(BH, T, hd, rkv_esz, w_esz):
    """r, k, v, o (rkv_esz), w (w_esz), u, s0 and sN (fp32) once."""
    return (4 * BH * T * hd * rkv_esz + BH * T * hd * w_esz
            + 4 * BH * hd + 2 * 4 * BH * hd * hd)


def wkv6(BH, T, hd, rkv_esz, w_esz):
    """B4, the RWKV6 recurrence: r, k, v, w, u, s0 read and o, sN written
    once; per step and row, hd·hd state elements, each k·v (1), w·S + a (2)
    and its share of rᵀS (2), plus the O(hd) bonus."""
    return bound(_wkv6_bytes(BH, T, hd, rkv_esz, w_esz),
                 5 * BH * T * hd * (hd + 1), FP32)


def wkv6_backward(BH, T, hd, rkv_esz, w_esz, ckpt_elems):
    """B4's backward: the forward's inputs and the upstream gradients (do
    in r's dtype, dsN fp32) read once, every gradient written once in its
    input's dtype; per state element and step the reverse walk's 4
    products (8) and G's update (3), in fp32. -> (ms, by, design ms, by):
    the design adds its ``ckpt_elems`` fp32 checkpoints read and the
    recompute of the states from them (k·v and w·S + a: 3)."""
    ins = _wkv6_bytes(BH, T, hd, rkv_esz, w_esz)
    grads = 3 * BH * T * hd * rkv_esz + BH * T * hd * w_esz \
        + 4 * BH * hd + 4 * BH * hd * hd
    nbytes = ins + grads
    flops = 11 * BH * T * hd * hd
    ms, by = bound(nbytes, flops, FP32)
    design, design_by = bound(nbytes + 4 * ckpt_elems,
                              flops + 3 * BH * T * hd * hd, FP32)
    return ms, by, design, design_by


def _scan_bytes(B, T, D, N, x_esz):
    """x, B, C (x_esz), dt, A, h0 read and y, h_T (fp32) written once."""
    return (x_esz * (B * T * D + 2 * B * T * N) + 4 * B * T * D + 4 * D * N
            + 4 * B * D * N + 4 * B * T * D + 4 * B * D * N)


def selective_scan(B, T, D, N, x_esz):
    """B5, the Mamba selective scan: per state element and step 7 fp32
    operations (dt·A, exp, dA·h, + dBx, dx·B, h·C, + y) and dt·x a
    channel."""
    return bound(_scan_bytes(B, T, D, N, x_esz), B * T * D * (7 * N + 1),
                 FP32)


def selective_scan_backward(B, T, D, N, x_esz, ckpt_elems, partial_elems):
    """B5's backward: the forward's inputs and the upstream gradients (dy,
    dh_T fp32) read once, every gradient written once in its input's
    dtype; 19 fp32 operations a state element and step (exp included).
    -> (ms, by, design ms, by): the design adds its ``ckpt_elems`` fp32
    checkpoints read, its ``partial_elems`` fp32 partials (dB/dC a block,
    dA a batch row) written and read back, and the recompute of the states
    from the checkpoints (dt·A, the exp, dt x·B and one fma: 4)."""
    ins = _scan_bytes(B, T, D, N, x_esz)
    grads = x_esz * (B * T * D + 2 * B * T * N) + 4 * B * T * D \
        + 4 * D * N + 4 * B * D * N
    nbytes = ins + grads
    flops = 19 * B * T * D * N
    ms, by = bound(nbytes, flops, FP32)
    design, design_by = bound(nbytes + 4 * ckpt_elems + 2 * 4 * partial_elems,
                              flops + 4 * B * T * D * N, FP32)
    return ms, by, design, design_by
