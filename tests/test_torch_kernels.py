"""The port's kernels (repro_torch.kernels) against the reference's oracles
and its Pallas kernels in interpret mode, on the same numpy-seeded inputs.

On the CPU the port runs each kernel's plain PyTorch version; the CUDA
kernels themselves are checked on the card by ``tests/test_torch_gpu.py``
and by ``chip_smoke.py`` at the served shapes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode as pallas_flash_decode
from repro.kernels.moe_ffn import moe_ffn as pallas_moe_ffn
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_decode import BLOCKS_PER_SM
from repro_torch.kernels.flash_decode import TILE as FD_TILE
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.flash_decode import splits as fd_splits
from repro_torch.kernels.moe_ffn import moe_ffn
from repro_torch.kernels import wkv6 as wkv_mod
from repro_torch.kernels.wkv6 import wkv6

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str):
    # tests/test_kernels.py's limits: fp32 sums in another order; bf16
    # rounds the hidden activation and the output
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=1e-4)


def _both(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor (bf16 rounds the
    float32 input to nearest even in both)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _moe_inputs(E, C, d, f, act, dtype, seed=0):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((E, C, d), np.float32)
    ws = [rng.standard_normal(s, np.float32) * 0.05
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    if act not in ("swiglu", "geglu"):
        ws[0] = None
    pairs = [_both(xg, dtype)] + [(None, None) if w is None else
                                  _both(w, dtype) for w in ws]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("E,C,d,f", [(2, 64, 128, 256), (4, 128, 256, 512),
                                     (1, 128, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_moe_ffn_plain_matches_reference_and_pallas(E, C, d, f, dtype, act):
    jx, tx = _moe_inputs(E, C, d, f, act, dtype)
    y = ref.moe_ffn_ref(*tx, act=act)
    assert y.dtype == tx[0].dtype and y.shape == (E, C, d)
    y_ref = jref.moe_ffn_ref(*jx, act=act)
    y_pallas = pallas_moe_ffn(*jx, act=act, block_c=64, block_f=128,
                              interpret=True)
    np.testing.assert_allclose(_f32(y), _f32(y_ref), **_tol(dtype))
    np.testing.assert_allclose(_f32(y), _f32(y_pallas), **_tol(dtype))
    # CPU dispatch takes the plain version
    assert torch.equal(ops.moe_expert_ffn(*tx, act=act), y)


@pytest.mark.parametrize("B,H,Hkv,hd,S", [(1, 4, 4, 64, 256),
                                          (2, 8, 2, 64, 512),
                                          (1, 16, 1, 128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_reference_and_pallas(B, H, Hkv, hd, S,
                                                         dtype):
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.standard_normal(s, np.float32), dtype)
        for s in ((B, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    for cache_len in (S, S - 17, 1):
        y = ref.flash_decode_ref(tq, tk, tv, cache_len)
        assert y.dtype == tq.dtype and y.shape == (B, H, hd)
        y_ref = jref.flash_decode_ref(jq, jk, jv, cache_len)
        y_pallas = pallas_flash_decode(jq, jk, jv, cache_len, block_s=128,
                                       interpret=True)
        np.testing.assert_allclose(_f32(y), _f32(y_ref), **_tol(dtype))
        np.testing.assert_allclose(_f32(y), _f32(y_pallas), **_tol(dtype))


# rows of each expert that carry a token (the rest of xg is exactly zero):
# a full expert, an empty one, one row, a scattered pair, empty again
ROUTED = [list(range(16)), [], [3], [0, 15], []]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_moe_ffn_zero_rows_give_zero_rows(dtype, act):
    """The invariant B1's kernel skips on: with no bias every activation
    maps a zero row of xg to a zero row of y, so a zero row (and an expert
    with only zero rows) needs no weight. Held by the port's plain version,
    the reference's oracle and the Pallas kernel in interpret mode on the
    same numpy-seeded inputs."""
    E, C, d, f = len(ROUTED), 16, 128, 256
    rng = np.random.default_rng(21)
    mask = np.zeros((E, C, 1), np.float32)
    for e, rows in enumerate(ROUTED):
        mask[e, rows] = 1.0
    xg = rng.standard_normal((E, C, d), np.float32) * mask
    ws = [rng.standard_normal(s, np.float32) * 0.05
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    if act not in ("swiglu", "geglu"):
        ws[0] = None
    pairs = [_both(xg, dtype)] + [(None, None) if w is None else
                                  _both(w, dtype) for w in ws]
    jx, tx = [p[0] for p in pairs], [p[1] for p in pairs]
    zero = mask[..., 0] == 0
    ys = {"port": ref.moe_ffn_ref(*tx, act=act),
          "reference": jref.moe_ffn_ref(*jx, act=act),
          "pallas": pallas_moe_ffn(*jx, act=act, block_c=16, block_f=128,
                                   interpret=True)}
    for name, y in ys.items():
        y = _f32(y)
        assert (y[zero] == 0).all(), name
        assert (y[~zero] != 0).any(axis=-1).all(), name


@pytest.mark.parametrize("rep", [1, 4, 16, 32])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_head_groups_and_lengths(rep, hd, dtype):
    """Query heads per KV head around the card kernel's tile of 16, both
    head dims, and per-row lengths 0 (every score masked: a uniform
    softmax), 1, S and between, against the reference's oracle and the
    Pallas kernel in interpret mode."""
    B, Hkv, S = 4, 2, 256
    rng = np.random.default_rng(22)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.standard_normal(s, np.float32), dtype)
        for s in ((B, Hkv * rep, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    lens = [0, 1, S, 97]
    y = ref.flash_decode_ref(tq, tk, tv, torch.tensor(lens, dtype=torch.int32))
    jl = jnp.asarray(lens, jnp.int32)
    y_ref = jref.flash_decode_ref(jq, jk, jv, jl)
    y_pallas = pallas_flash_decode(jq, jk, jv, jl, block_s=128,
                                   interpret=True)
    np.testing.assert_allclose(_f32(y), _f32(y_ref), **_tol(dtype))
    np.testing.assert_allclose(_f32(y), _f32(y_pallas), **_tol(dtype))
    # length 0: the mean of V over all S positions, per KV head
    mean_v = _f32(tv[0]).mean(axis=0)                       # (Hkv, hd)
    np.testing.assert_allclose(_f32(y[0]).reshape(Hkv, rep, hd),
                               np.repeat(mean_v[:, None], rep, axis=1),
                               **_tol(dtype))


@pytest.mark.parametrize("B,Hkv,rep,S,want", [
    (4, 4, 16, 64, 1),          # the served decode shape: no split
    (4, 4, 16, 32768, 32),      # the long-cache row: 32 runs of 1024
    (3, 1, 16, 1000, 16),       # few blocks: every tile its own split
    (1, 64, 1, 100000, 9),      # many blocks: long runs
    (2, 2, 32, 4096, 64),       # two head tiles per KV head
])
def test_flash_decode_split_policy(B, Hkv, rep, S, want):
    """The split of S across blocks follows from S and the grid alone: whole
    tiles per split, the splits cover S, and a split exists only where the
    grid would leave SMs idle."""
    n, L = fd_splits(B, Hkv, rep, S, n_sm=132)
    assert n == want
    assert L % FD_TILE == 0 and n * L >= S > (n - 1) * L
    blocks = B * Hkv * -(-rep // 16)
    assert n == 1 or blocks * n <= 2 * BLOCKS_PER_SM * 132


@pytest.mark.parametrize("BH,hd,want", [
    (256, 64, (4, 32)),     # decode, 4 rows x 64 heads: 512 blocks
    (64, 64, (8, 16)),      # a prompt at B = 1: 128 blocks would idle SMs
    (1, 64, (8, 16)),
    (132, 64, (4, 32)),     # two blocks of 32 columns per SM already
    (3, 32, (4, 16)),
    (300, 32, (2, 32)),
])
def test_wkv6_launch_plan(BH, hd, want):
    """B4's split of each row's (hd, hd) state: column blocks of ``cols``
    and row groups cover every (row, column) of the state exactly once,
    whole warps or one, and fat threads only when the grid fills the
    card."""
    groups, cols = wkv_mod.plan(BH, hd, n_sm=132)
    assert (groups, cols) == want
    rows = hd // groups
    assert groups * rows == hd and hd % cols == 0
    assert rows in (wkv_mod.ROWS, wkv_mod.MANY_ROWS)
    assert (groups * cols) % 32 == 0
    cover = np.zeros((hd, hd), int)
    for block in range(hd // cols):
        for g in range(groups):
            for j in range(cols):
                cover[g * rows:(g + 1) * rows, block * cols + j] += 1
    assert (cover == 1).all()
    fills = BH * hd // min(wkv_mod.COLS, hd) >= wkv_mod.BLOCKS_PER_SM * 132
    assert (rows == wkv_mod.MANY_ROWS) == fills


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_per_slot_lengths(dtype):
    """Each batch row masks its own valid prefix; a row's output does not
    depend on the other rows' lengths."""
    B, H, Hkv, hd, S = 4, 8, 2, 64, 256
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.standard_normal(s, np.float32), dtype)
        for s in ((B, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    lens = [S, 7, 129, 1]
    y = ops.decode_attention(tq, tk, tv, torch.tensor(lens, dtype=torch.int32))
    y_pallas = pallas_flash_decode(jq, jk, jv, jnp.asarray(lens, jnp.int32),
                                   block_s=128, interpret=True)
    np.testing.assert_allclose(_f32(y), _f32(y_pallas), **_tol(dtype))
    for b, L in enumerate(lens):
        assert torch.equal(y[b], ref.flash_decode_ref(tq, tk, tv, L)[b])


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its CUDA kernel or raises: it never runs the plain
    version itself (that choice belongs to ops, by device)."""
    x = torch.zeros(2, 4, 8)
    w = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        moe_ffn(x, w, w, torch.zeros(2, 16, 8))
    q = torch.zeros(1, 4, 8)
    kv = torch.zeros(1, 16, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q, kv, kv, 16)
    r = torch.zeros(2, 3, 64)
    with pytest.raises(ValueError, match="CUDA"):
        wkv6(r, r, r, r, torch.zeros(2, 64), torch.zeros(2, 64, 64))
