"""The port's CUDA kernels and its model on the card, against their plain
PyTorch versions and the CPU. Every test needs an NVIDIA GPU with nvcc and
skips without one; this file imports no JAX, so it runs where the port
runs:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.slot_cache import ExpertSlotCache, HostExpertStore
from repro_torch.kernels import decode_split as ds_mod
from repro_torch.kernels import flash_decode as fd_mod
from repro_torch.kernels import moe_ffn as moe_mod
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as scan_mod
from repro_torch.kernels import wkv6 as wkv_mod
from repro_torch.launch import spmd
from repro_torch.models import Model
from repro_torch.serving import EngineConfig, TorchModelServer

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype: str):
    # as tests/test_kernels.py: fp32 sums in another order; bf16 rounds the
    # hidden activation and the output
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, std, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, np.float32) * std) \
        .to(dev, DTYPES[dtype])


def _f32(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_moe_ffn_kernel_matches_plain(cuda, dtype, act):
    rng = np.random.default_rng(5)
    E, C, d, f = 3, 13, 520, 700          # no tile divides C, d or f
    xg = _rand(rng, (E, C, d), 1.0, dtype, cuda)
    wg = (_rand(rng, (E, d, f), d ** -0.5, dtype, cuda)
          if act in ("swiglu", "geglu") else None)
    wu = _rand(rng, (E, d, f), d ** -0.5, dtype, cuda)
    wd = _rand(rng, (E, f, d), f ** -0.5, dtype, cuda)
    before = moe_mod.launches
    y = moe_mod.moe_ffn(xg, wg, wu, wd, act=act)
    assert moe_mod.launches == before + 1
    np.testing.assert_allclose(_f32(y), _f32(ref.moe_ffn_ref(
        xg, wg, wu, wd, act=act)), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_matches_plain(cuda, dtype):
    """Per-slot lengths, including a full cache, one position and none
    (the reference's softmax over all-masked scores is uniform)."""
    rng = np.random.default_rng(4)
    q = _rand(rng, (4, 16, 64), 1.0, dtype, cuda)
    k = _rand(rng, (4, 300, 4, 64), 1.0, dtype, cuda)
    v = _rand(rng, (4, 300, 4, 64), 1.0, dtype, cuda)
    lens = torch.tensor([300, 1, 0, 299], dtype=torch.int32, device=cuda)
    before = fd_mod.launches
    y = fd_mod.flash_decode(q, k, v, lens)
    assert fd_mod.launches == before + 1
    np.testing.assert_allclose(_f32(y), _f32(ref.flash_decode_ref(
        q, k, v, lens)), **_tol(dtype))


def _bits_zero(t):
    """Every element is +0.0 (all bits clear)."""
    ints = torch.int16 if t.element_size() == 2 else torch.int32
    return bool((t.contiguous().view(ints) == 0).all())


# which rows of each expert carry a token; every other row is exactly zero:
# a full expert, an empty one, one routed row, a scattered pair, and empty
ROUTED = [list(range(13)), [], [5], [0, 12], []]


@pytest.mark.parametrize("E,C,d,f", [(5, 13, 520, 700),    # ragged: no tile
                                     (5, 13, 512, 384)])   # 16-byte rows
@pytest.mark.parametrize("slots", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_moe_ffn_kernel_skips_unrouted_rows(cuda, E, C, d, f, slots, dtype,
                                            act):
    """Sparse occupancy as the dispatch makes it at decode: empty experts,
    one-row experts, zero rows between routed ones; through a slot table
    too. The kernel matches the plain version, and every zero row of xg
    gives a +0.0 row of y."""
    rng = np.random.default_rng(11)
    n = E + 2 if slots else E
    xg = _rand(rng, (E, C, d), 1.0, dtype, cuda)
    routed = torch.zeros((E, C), dtype=torch.bool, device=cuda)
    for e, rows in enumerate(ROUTED):
        routed[e, rows] = True
    xg = xg * routed[..., None].to(xg.dtype)
    wg = (_rand(rng, (n, d, f), d ** -0.5, dtype, cuda)
          if act in ("swiglu", "geglu") else None)
    wu = _rand(rng, (n, d, f), d ** -0.5, dtype, cuda)
    wd = _rand(rng, (n, f, d), f ** -0.5, dtype, cuda)
    ids = (torch.tensor([6, 0, 3, 1, 5], dtype=torch.int32, device=cuda)
           if slots else None)
    y = moe_mod.moe_ffn(xg, wg, wu, wd, act=act, slot_ids=ids)
    idx = ids.long() if slots else torch.arange(E, device=cuda)
    want = ref.moe_ffn_ref(xg, None if wg is None else wg[idx], wu[idx],
                           wd[idx], act=act)
    np.testing.assert_allclose(_f32(y), _f32(want), **_tol(dtype))
    assert _bits_zero(y[~routed])
    assert not bool((y[routed] == 0).all(dim=-1).any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_kernel_with_every_expert_empty(cuda, dtype):
    xg = torch.zeros((4, 8, 256), dtype=DTYPES[dtype], device=cuda)
    w = torch.full((4, 256, 128), float("nan"), dtype=DTYPES[dtype],
                   device=cuda)
    wd = torch.full((4, 128, 256), float("nan"), dtype=DTYPES[dtype],
                    device=cuda)
    # no weight is read: the NaN weights never reach the output
    y = moe_mod.moe_ffn(xg, w, w, wd, act="swiglu")
    assert y.shape == xg.shape and _bits_zero(y)


@pytest.mark.parametrize("rep", [1, 4, 16, 32])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_head_groups(cuda, rep, hd, dtype):
    """Query heads per KV head below, at and above the tensor-core tile's
    16, both head dims; lengths 0 (uniform softmax), 1, S and ragged."""
    rng = np.random.default_rng(12)
    B, Hkv, S = 4, 2, 200
    q = _rand(rng, (B, Hkv * rep, hd), 1.0, dtype, cuda)
    k = _rand(rng, (B, S, Hkv, hd), 1.0, dtype, cuda)
    v = _rand(rng, (B, S, Hkv, hd), 1.0, dtype, cuda)
    lens = torch.tensor([0, 1, S, 77], dtype=torch.int32, device=cuda)
    y = fd_mod.flash_decode(q, k, v, lens)
    np.testing.assert_allclose(_f32(y), _f32(ref.flash_decode_ref(
        q, k, v, lens)), **_tol(dtype))


@pytest.mark.parametrize("rep,hd", [(16, 128), (4, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_splits_long_cache(cuda, rep, hd, dtype):
    """A long cache over few KV heads is split across blocks and the splits
    combined; rows of length 0, 1, S and in between."""
    rng = np.random.default_rng(13)
    B, Hkv, S = 4, 1, 4096
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fd_mod.splits(B, Hkv, rep, S, n_sm)[0] > 1
    q = _rand(rng, (B, Hkv * rep, hd), 1.0, dtype, cuda)
    k = _rand(rng, (B, S, Hkv, hd), 1.0, dtype, cuda)
    v = _rand(rng, (B, S, Hkv, hd), 1.0, dtype, cuda)
    lens = torch.tensor([S, 0, 1, 2049], dtype=torch.int32, device=cuda)
    y = fd_mod.flash_decode(q, k, v, lens)
    np.testing.assert_allclose(_f32(y), _f32(ref.flash_decode_ref(
        q, k, v, lens)), **_tol(dtype))


# B3 at the decode shapes of the families served through it since hd 256
# and the softcap: Gemma-2 (8/4 heads x 256, softcap 50, a 4096-position
# ring), Whisper's cross-attention (12/12 heads x 64 over its 1500 encoder
# positions) and Qwen2-VL (64/8 heads x 128)
B3_FAMILIES = {"gemma2": (4, 8, 4, 256, 4096, 50.0),
               "whisper_cross": (4, 12, 12, 64, 1500, 0.0),
               "qwen2_vl": (4, 64, 8, 128, 600, 0.0)}


@pytest.mark.parametrize("family", list(B3_FAMILIES))
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_at_family_shapes(cuda, family, ragged, dtype):
    """Every row full (a ring that has wrapped, or the encoder's length)
    and ragged rows of length S, 1, 0 and in between. q is scaled so that
    Gemma's scores reach the cap's bend (|s| ~ 10-40 against cap 50)."""
    B, H, Hkv, hd, S, cap = B3_FAMILIES[family]
    rng = np.random.default_rng(21)
    q = _rand(rng, (B, H, hd), 8.0 if cap else 1.0, dtype, cuda)
    k = _rand(rng, (B, S, Hkv, hd), 1.0, dtype, cuda)
    v = _rand(rng, (B, S, Hkv, hd), 1.0, dtype, cuda)
    lens = torch.tensor([S, 1, 0, S // 2 + 3] if ragged else [S] * B,
                        dtype=torch.int32, device=cuda)
    before = fd_mod.launches
    y = fd_mod.flash_decode(q, k, v, lens, softcap=cap)
    assert fd_mod.launches == before + 1
    np.testing.assert_allclose(_f32(y), _f32(ref.flash_decode_ref(
        q, k, v, lens, cap)), **_tol(dtype))


@pytest.mark.parametrize("rep", [1, 2, 20])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_softcap_and_head_dims(cuda, rep, hd, cap, dtype):
    """Each head dim with and without the softcap, KV groups below, at and
    above one tensor-core tile of 16 heads, one split and several."""
    rng = np.random.default_rng(22)
    B, Hkv = 4, 2
    for S in (300, 4096):
        q = _rand(rng, (B, Hkv * rep, hd), 6.0, dtype, cuda)
        k = _rand(rng, (B, S, Hkv, hd), 1.0, dtype, cuda)
        v = _rand(rng, (B, S, Hkv, hd), 1.0, dtype, cuda)
        lens = torch.tensor([0, 1, S, S // 3], dtype=torch.int32,
                            device=cuda)
        y = fd_mod.flash_decode(q, k, v, lens, softcap=cap)
        np.testing.assert_allclose(_f32(y), _f32(ref.flash_decode_ref(
            q, k, v, lens, cap)), **_tol(dtype))


@pytest.mark.parametrize("hd,cap", [(64, 0.0), (128, 0.0), (256, 50.0)])
@pytest.mark.parametrize("S", [300, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_lse_matches_plain(cuda, hd, cap, S, dtype):
    """``return_lse``: the output and each row's log-sum-exp against the
    plain version's, one split and several; rows of length 0 give out 0
    and lse -inf (the launch without lse keeps the uniform softmax there);
    the other rows' outputs are bit-equal to the launch without lse."""
    rng = np.random.default_rng(24)
    B, Hkv, rep = 4, 2, 4
    q = _rand(rng, (B, Hkv * rep, hd), 6.0 if cap else 1.0, dtype, cuda)
    k = _rand(rng, (B, S, Hkv, hd), 1.0, dtype, cuda)
    v = _rand(rng, (B, S, Hkv, hd), 1.0, dtype, cuda)
    lens = torch.tensor([0, 1, S, S // 3], dtype=torch.int32, device=cuda)
    y, lse = fd_mod.flash_decode(q, k, v, lens, softcap=cap,
                                 return_lse=True)
    want, want_lse = ref.flash_decode_ref(q, k, v, lens, cap,
                                          return_lse=True)
    np.testing.assert_allclose(_f32(y), _f32(want), **_tol(dtype))
    assert bool((lse[0] == -torch.inf).all()) and bool((y[0] == 0).all())
    np.testing.assert_allclose(_f32(lse[1:]), _f32(want_lse[1:]), atol=1e-3,
                               rtol=1e-4)
    plain = fd_mod.flash_decode(q, k, v, lens, softcap=cap)
    assert torch.equal(plain[1:], y[1:])


@pytest.mark.parametrize("blocks", [2, 4, 16])
def test_flash_decode_lse_merge_equals_the_unsplit_kernel(cuda, blocks):
    """B3 over a 4096-position cache cut into blocks (lengths clamped to
    each, later blocks of short rows empty), merged by
    ``spmd.merge_blocks``, equals the unsplit launch."""
    rng = np.random.default_rng(25)
    B, H, Hkv, hd, S = 4, 32, 2, 128, 4096
    q = _rand(rng, (B, H, hd), 1.0, "float32", cuda)
    k = _rand(rng, (B, S, Hkv, hd), 1.0, "float32", cuda)
    v = _rand(rng, (B, S, Hkv, hd), 1.0, "float32", cuda)
    lens = torch.tensor([S, 3000, 200, 1], dtype=torch.int32, device=cuda)
    n = S // blocks
    parts = [fd_mod.flash_decode(
        q, k[:, i * n:(i + 1) * n].contiguous(),
        v[:, i * n:(i + 1) * n].contiguous(),
        torch.clamp(lens - i * n, 0, n).to(torch.int32), return_lse=True)
        for i in range(blocks)]
    merged = spmd.merge_blocks(torch.stack([p[0] for p in parts]),
                           torch.stack([p[1] for p in parts]))
    np.testing.assert_allclose(_f32(merged), _f32(fd_mod.flash_decode(
        q, k, v, lens)), **_tol("float32"))


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S", [300, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_softcap_zero_leaves_results_unchanged(cuda, hd, S,
                                                             dtype):
    """softcap = 0 takes the uncapped instantiation: bit-equal to the call
    without the argument and from launch to launch (the splits combine in a
    fixed order); a cap changes the result. ``scripts/kernel_ab.py`` holds
    these shapes bit-equal to another tree's kernel."""
    rng = np.random.default_rng(23)
    B, Hkv, rep = 4, 2, 8
    q = _rand(rng, (B, Hkv * rep, hd), 6.0, dtype, cuda)
    k = _rand(rng, (B, S, Hkv, hd), 1.0, dtype, cuda)
    v = _rand(rng, (B, S, Hkv, hd), 1.0, dtype, cuda)
    lens = torch.tensor([S, 1, S // 2, 7], dtype=torch.int32, device=cuda)
    y = fd_mod.flash_decode(q, k, v, lens)
    assert torch.equal(fd_mod.flash_decode(q, k, v, lens, softcap=0.0), y)
    assert torch.equal(fd_mod.flash_decode(q, k, v, lens), y)
    assert not torch.equal(fd_mod.flash_decode(q, k, v, lens, softcap=5.0),
                           y)


# B3-qk / B3-pv: (B, H, Hkv, hd, S, lengths, softcap) -- qwen3-moe's
# 64/4 heads, MQA, Gemma-2's hd 256 with its softcap over a ragged ring,
# Whisper's cross-attention (hd 64, rep 1), a long cache that B3-pv splits,
# rows with no valid position, qwen2-1.5b's 12/2 heads (rep 6: the
# tensor-core tile's M padded from 6 to 16), lengths that end inside a
# 16-position chunk and on either side of B3-pv's splits (of 128 here), and
# an S that is no multiple of 4 (both halves on their CUDA-core paths in
# bf16 too)
SPLIT_CASES = [(4, 64, 4, 128, 64, [1, 17, 40, 64], 0.0),
               (3, 16, 1, 128, 1000, [1000, 513, 1], 0.0),
               (4, 8, 4, 256, 4096, [4096, 1, 2500, 17], 50.0),
               (4, 12, 12, 64, 1500, [1500] * 4, 0.0),
               (2, 16, 2, 128, 20000, [20000, 7001], 0.0),
               (3, 16, 2, 128, 300, [0, 300, 0], 0.0),
               (2, 12, 2, 128, 2000, [2000, 77], 0.0),
               (5, 16, 2, 128, 2048, [1, 15, 17, 1023, 1025], 0.0),
               (2, 16, 2, 128, 1001, [1001, 500], 0.0)]


def _split_inputs(case, dtype, dev, seed):
    B, H, Hkv, hd, S, lens, cap = case
    rng = np.random.default_rng(seed)
    q = _rand(rng, (B, H, hd), 8.0 if cap else 1.0, dtype, dev)
    k = _rand(rng, (B, S, Hkv, hd), 1.0, dtype, dev)
    v = _rand(rng, (B, S, Hkv, hd), 1.0, dtype, dev)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev), cap


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_kernels_match_plain(cuda, case, n, dtype):
    """B3-qk over each of ``n`` head_dim slices against
    ``ref.decode_scores_ref`` (exactly 0 past each length), the scores
    summed as the all-reduce sums them, then B3-pv over each V slice
    against ``ref.decode_values_ref`` with and without lse (-inf and out 0
    where a row has no position), and the slices side by side against
    unsplit B3 where every row has a position."""
    q, k, v, lens, cap = _split_inputs(SPLIT_CASES[case], dtype, cuda, case)
    hd = q.shape[-1]
    w = hd // n
    sl = [slice(i * w, (i + 1) * w) for i in range(n)]
    before = (ds_mod.scores_launches, ds_mod.values_launches)
    parts = []
    for s in sl:
        qs, ks = q[..., s].contiguous(), k[..., s].contiguous()
        got = ds_mod.decode_scores(qs, ks, lens, hd ** -0.5)
        want = ref.decode_scores_ref(qs, ks, lens, hd ** -0.5)
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   **_tol("float32"))
        past = torch.arange(k.shape[1], device=cuda) >= lens[:, None, None]
        assert not bool(got[past.expand_as(got)].any())
        parts.append(got)
    scores = torch.stack(parts).sum(0)
    outs = []
    for s in sl:
        vs = v[..., s].contiguous()
        out, lse = ds_mod.decode_values(scores, vs, lens, cap,
                                        return_lse=True)
        wo, wl = ref.decode_values_ref(scores, vs, lens, cap,
                                       return_lse=True)
        np.testing.assert_allclose(_f32(out), _f32(wo), **_tol(dtype))
        empty = wl == -torch.inf
        assert torch.equal(lse == -torch.inf, empty)
        assert not bool(out[empty].any())
        np.testing.assert_allclose(_f32(lse[~empty]), _f32(wl[~empty]),
                                   atol=1e-3, rtol=1e-4)
        plain = ds_mod.decode_values(scores, vs, lens, cap)
        assert torch.equal(plain, out)
        outs.append(plain)
    assert (ds_mod.scores_launches, ds_mod.values_launches) == (
        before[0] + n, before[1] + 2 * n)
    if int(lens.min()) >= 1:
        np.testing.assert_allclose(
            _f32(torch.cat(outs, -1)),
            _f32(fd_mod.flash_decode(q, k, v, lens, cap)), **_tol(dtype))


def test_decode_split_kernels_are_deterministic(cuda):
    """Two launches of each half give the same bits (B3-pv's splits
    combine in a fixed order), in bf16 (tensor cores) and fp32 (CUDA
    cores), over one of 2 and one of 16 head_dim slices."""
    for dtype in ("bfloat16", "float32"):
        q, k, v, lens, cap = _split_inputs(SPLIT_CASES[4], dtype, cuda, 9)
        for w in (64, 8):
            qs, ks, vs = (t[..., :w].contiguous() for t in (q, k, v))
            s1 = ds_mod.decode_scores(qs, ks, lens, 0.1)
            s2 = ds_mod.decode_scores(qs, ks, lens, 0.1)
            assert torch.equal(s1, s2), (dtype, w)
            assert torch.equal(ds_mod.decode_values(s1, vs, lens),
                               ds_mod.decode_values(s1, vs, lens)), (dtype, w)


def test_decode_split_wrappers_validate_inputs(cuda):
    q = torch.zeros(1, 4, 8, device=cuda)
    kv = torch.zeros(1, 16, 2, 8, device=cuda)
    s = torch.zeros(1, 4, 16, device=cuda)
    with pytest.raises(TypeError):
        ds_mod.decode_scores(q.half(), kv.half(), 16, 0.1)
    with pytest.raises(ValueError, match="on cpu"):
        ds_mod.decode_scores(q, kv.cpu(), 16, 0.1)
    with pytest.raises(ValueError, match="multiple"):
        ds_mod.decode_scores(q[:, :3].contiguous(), kv, 16, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        ds_mod.decode_values(s, kv.transpose(1, 2).contiguous()
                             .transpose(1, 2), 16)
    with pytest.raises(TypeError, match="float32"):
        ds_mod.decode_values(s.bfloat16(), kv, 16)
    with pytest.raises(ValueError, match="softcap"):
        ds_mod.decode_values(s, kv, 16, softcap=-1.0)
    with pytest.raises(ValueError, match="head_dim slice"):
        ds_mod.decode_scores(torch.zeros(1, 4, 12, device=cuda),
                             torch.zeros(1, 16, 2, 12, device=cuda), 16, 0.1)
    with pytest.raises(ValueError, match="head_dim slice"):
        ds_mod.decode_values(s, torch.zeros(1, 16, 2, 256, device=cuda), 16)
    qg = q.requires_grad_()
    with pytest.raises(NotImplementedError):
        ds_mod.decode_scores(qg, kv, 16, 0.1)


def test_decode_values_launch_takes_splits_of_whole_tiles(cuda):
    """The C entry point takes a split of whole ``decode_split.TILE``
    positions (its warps' cp.async steps) and refuses any other when it
    splits: the split rule and the kernel's tile cannot drift apart."""
    from repro_torch.kernels import build
    B, H, Hkv, hd, S, tile = 1, 16, 1, 64, 512, ds_mod.TILE
    scores = torch.zeros(B, H, S, device=cuda)
    v = torch.zeros(B, S, Hkv, hd, device=cuda, dtype=torch.bfloat16)
    lens = torch.full((B,), S, dtype=torch.int32, device=cuda)
    out = torch.empty(B, H, hd, device=cuda, dtype=torch.bfloat16)
    part = torch.empty(B * H * (S // 32) * (hd + 2), device=cuda)
    fn = build.load("decode_values")
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def launch(split_len):
        return fn(scores.data_ptr(), v.data_ptr(), lens.data_ptr(),
                  out.data_ptr(), part.data_ptr(), None, B, S, Hkv, H // Hkv,
                  hd, -(-S // split_len), split_len, 0.0,
                  build.DTYPES[torch.bfloat16], stream)
    assert launch(tile) == 0
    torch.cuda.synchronize()
    assert launch(tile // 2) != 0
    assert launch(tile + 32) != 0


def test_kernel_wrappers_validate_inputs(cuda):
    x = torch.zeros(2, 4, 8, device=cuda)
    w = torch.zeros(2, 8, 16, device=cuda)
    wd = torch.zeros(2, 16, 8, device=cuda)
    with pytest.raises(TypeError):
        moe_mod.moe_ffn(x.half(), w.half(), w.half(), wd.half())
    with pytest.raises(ValueError, match="contiguous"):
        moe_mod.moe_ffn(x, w, w.transpose(1, 2).contiguous().transpose(
            1, 2), wd)
    with pytest.raises(ValueError, match="w_gate"):
        moe_mod.moe_ffn(x, None, w, wd, act="swiglu")
    with pytest.raises(ValueError, match="shape"):
        moe_mod.moe_ffn(x, w, w, wd[:, :8])
    q = torch.zeros(1, 4, 8, device=cuda)
    kv = torch.zeros(1, 16, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="on cpu"):
        fd_mod.flash_decode(q, kv, kv.cpu(), 16)
    with pytest.raises(ValueError, match="hd in"):
        fd_mod.flash_decode(q, kv, kv, 16)
    q, kv = torch.zeros(1, 4, 64, device=cuda), torch.zeros(1, 16, 2, 64,
                                                            device=cuda)
    with pytest.raises(ValueError, match="softcap"):
        fd_mod.flash_decode(q, kv, kv, 16, softcap=-1.0)


def test_model_and_server_on_card_match_cpu(cuda):
    """The whole port on the card (kernels) against the same weights on
    the CPU (plain versions): logits, counts and served tokens."""
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    gpu = Model(cfg, device=cuda).init(3)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)))
    with torch.inference_mode():
        lg, ag = gpu.forward({"tokens": toks.to(cuda)})
        lc, ac = cpu.forward({"tokens": toks})
    np.testing.assert_allclose(_f32(lg), lc.numpy(), atol=1e-4, rtol=1e-4)
    assert torch.equal(ag["counts"].cpu(), ac["counts"])

    def serve(model, device):
        srv = TorchModelServer(
            EngineConfig(arch=cfg, gpu_cache_experts=3,
                         dram_cache_experts=6), model, cache_len=32,
            device=device)
        prompts = np.random.default_rng(1).integers(0, cfg.vocab, (3, 9))
        out, stats = srv.generate(prompts.astype(np.int32), 6)
        return out, stats, srv
    g_out, g_stats, g_srv = serve(gpu, cuda)
    c_out, c_stats, _ = serve(cpu, "cpu")
    np.testing.assert_array_equal(g_out, c_out)
    assert g_stats["demand_fetches"] == c_stats["demand_fetches"]
    assert len(g_srv.decode_ms) == g_srv.n_decode_steps > 0


def _wire(rng, n, shape, wire, dev):
    """(n, *shape) fp16 or int8 weights and (n, shape[-1]) fp32 scales
    (None for fp16)."""
    w = rng.standard_normal((n,) + shape, np.float32) * shape[0] ** -0.5
    if wire == "fp16":
        return torch.from_numpy(w).to(dev, torch.float16), None
    q = rng.integers(-127, 128, (n,) + shape).astype(np.int8)
    s = np.abs(w).max(axis=1) / 127.0
    return torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)


@pytest.mark.parametrize("wire", ["int8", "fp16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_moe_ffn_quant_kernel_matches_plain(cuda, wire, dtype, act, out):
    """B2 over slot buffers, with a permuted slot table in which one
    expert is clamped to slot 0, on ragged shapes."""
    rng = np.random.default_rng(6)
    E, C, d, f, n = 3, 13, 520, 700, 4
    xg = _rand(rng, (E, C, d), 1.0, dtype, cuda)
    wg, sg = (_wire(rng, n, (d, f), wire, cuda) if act == "swiglu"
              else (None, None))
    wu, su = _wire(rng, n, (d, f), wire, cuda)
    wd, sd = _wire(rng, n, (f, d), wire, cuda)
    slots = torch.tensor([3, 0, 0], dtype=torch.int32, device=cuda)
    before = moe_mod.quant_launches
    y = moe_mod.moe_ffn_quant(xg, wg, wu, wd, sg, su, sd, slots, act=act,
                              out_dtype=DTYPES[out])
    assert moe_mod.quant_launches == before + 1
    assert y.dtype == DTYPES[out]
    want = ref.moe_ffn_quant_ref(xg, wg, wu, wd, sg, su, sd, slots, act=act,
                                 out_dtype=DTYPES[out])
    # x, the dequantized weights and h are fp32 on both sides: only the
    # summation order differs, unless the output is rounded to bf16
    np.testing.assert_allclose(_f32(y), _f32(want), **_tol(out))


def _routed_xg(rng, E, C, d, dtype, dev):
    """xg with the rows of ``ROUTED`` filled and every other row exactly
    zero; -> (xg, (E, C) bool mask of the routed rows)."""
    xg = _rand(rng, (E, C, d), 1.0, dtype, dev)
    routed = torch.zeros((E, C), dtype=torch.bool, device=dev)
    for e, rows in enumerate(ROUTED):
        routed[e, rows] = True
    return xg * routed[..., None].to(xg.dtype), routed


def _quant_slots(rng, n, d, f, act, wire, dev):
    """(w_gate, w_up, w_down, s_gate, s_up, s_down) slot buffers."""
    wg, sg = (_wire(rng, n, (d, f), wire, dev) if act in ("swiglu", "geglu")
              else (None, None))
    wu, su = _wire(rng, n, (d, f), wire, dev)
    wd, sd = _wire(rng, n, (f, d), wire, dev)
    return wg, wu, wd, sg, su, sd


def _poison(bufs, slot):
    """Fill slot ``slot`` of every buffer with NaN: fp16 weights and int8
    scales (int8 weights hold no NaN)."""
    for b in bufs:
        if b is not None and b.is_floating_point():
            b[slot] = float("nan")


@pytest.mark.parametrize("E,C,d,f", [(5, 13, 520, 700),    # ragged: no tile
                                     (5, 13, 512, 384)])   # 16-byte rows
@pytest.mark.parametrize("wire", ["int8", "fp16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_moe_ffn_quant_kernel_skips_unrouted_rows(cuda, E, C, d, f, wire,
                                                  dtype, act, out):
    """B2 at sparse occupancy as the dispatch makes it at decode: empty
    experts, one-row experts, zero rows between routed ones, through a
    permuted slot table. The kernel matches the plain version, and every
    zero row of xg gives a +0.0 row of y."""
    rng = np.random.default_rng(14)
    n = E + 2
    xg, routed = _routed_xg(rng, E, C, d, dtype, cuda)
    ws = _quant_slots(rng, n, d, f, act, wire, cuda)
    ids = torch.tensor([6, 0, 3, 1, 5], dtype=torch.int32, device=cuda)
    before = moe_mod.quant_launches
    y = moe_mod.moe_ffn_quant(xg, *ws, ids, act=act, out_dtype=DTYPES[out])
    assert moe_mod.quant_launches == before + 1
    want = ref.moe_ffn_quant_ref(xg, *ws, ids, act=act,
                                 out_dtype=DTYPES[out])
    np.testing.assert_allclose(_f32(y), _f32(want), **_tol(out))
    assert _bits_zero(y[~routed])
    assert not bool((y[routed] == 0).all(dim=-1).any())


@pytest.mark.parametrize("wire", ["int8", "fp16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_quant_kernel_with_every_expert_empty(cuda, wire, dtype):
    """Every slot holds NaN (fp16 weights, int8 scales) and xg is all zero:
    the result is all +0.0, so no weight and no scale was read."""
    rng = np.random.default_rng(15)
    E, C, d, f = 4, 8, 256, 128
    xg = torch.zeros((E, C, d), dtype=DTYPES[dtype], device=cuda)
    ws = _quant_slots(rng, E, d, f, "swiglu", wire, cuda)
    for slot in range(E):
        _poison(ws, slot)
    ids = torch.arange(E, dtype=torch.int32, device=cuda)
    y = moe_mod.moe_ffn_quant(xg, *ws, ids, act="swiglu",
                              out_dtype=torch.float32)
    assert y.shape == xg.shape and _bits_zero(y)


@pytest.mark.parametrize("wire", ["int8", "fp16"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_ffn_quant_kernel_unrouted_experts_on_a_nan_slot(cuda, wire,
                                                            act):
    """A slot table in which the experts with nothing routed point at a
    NaN-filled slot (as a table may for experts not resident): their rows
    are +0.0 and the routed experts match the plain version over a table
    that points the unrouted ones at a finite slot."""
    rng = np.random.default_rng(16)
    E, C, d, f = 5, 13, 512, 384
    n = E + 2
    xg, routed = _routed_xg(rng, E, C, d, "bfloat16", cuda)
    ws = _quant_slots(rng, n, d, f, act, wire, cuda)
    busy, nan_slot = [6, 0, 3, 1, 5], 2       # slot 2 serves no expert
    _poison(ws, nan_slot)
    nan_ids = torch.tensor([s if ROUTED[e] else nan_slot
                            for e, s in enumerate(busy)],
                           dtype=torch.int32, device=cuda)
    ok_ids = torch.tensor(busy, dtype=torch.int32, device=cuda)
    y = moe_mod.moe_ffn_quant(xg, *ws, nan_ids, act=act,
                              out_dtype=torch.float32)
    want = ref.moe_ffn_quant_ref(xg, *ws, ok_ids, act=act,
                                 out_dtype=torch.float32)
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(_f32(y), _f32(want), **_tol("float32"))
    assert _bits_zero(y[~routed])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_kernel_with_slot_ids_matches_plain(cuda, dtype):
    rng = np.random.default_rng(7)
    E, C, d, f, n = 3, 13, 520, 700, 5
    xg = _rand(rng, (E, C, d), 1.0, dtype, cuda)
    wg, wu = (_rand(rng, (n, d, f), d ** -0.5, dtype, cuda) for _ in "gu")
    wd = _rand(rng, (n, f, d), f ** -0.5, dtype, cuda)
    slots = torch.tensor([4, 1, 0], dtype=torch.int32, device=cuda)
    y = moe_mod.moe_ffn(xg, wg, wu, wd, act="swiglu", slot_ids=slots)
    idx = slots.long()
    np.testing.assert_allclose(_f32(y), _f32(ref.moe_ffn_ref(
        xg, wg[idx], wu[idx], wd[idx], act="swiglu")), **_tol(dtype))


def test_inflight_kernel_never_reads_a_committed_overwrite(cuda):
    """No alias on the card, at the full expert shape: a B2 launch over
    slot s is enqueued, then s is evicted, re-staged with another expert on
    the copy stream and committed. The first launch computes with the old
    weights; a launch after the commit sees the new ones."""
    full = get_config("qwen3-moe-235b-a22b")
    model = Model(dataclasses.replace(full, n_layers=1), device=cuda).init(0)
    store = HostExpertStore(model, transfer_dtype="int8")
    assert not hasattr(model.layers[0].moe, "w_up")
    cache = ExpertSlotCache(store, n_slots=2)
    cache.prefetch([(0, 0), (0, 1)])
    bufs = cache.commit()
    s = int(cache.slot_of[0, 0])
    E, d = full.moe.n_experts, full.d_model
    gen = torch.Generator(device=cuda).manual_seed(0)
    xg = torch.randn((E, 8, d), generator=gen, device=cuda).to(torch.bfloat16)
    slots = torch.full((E,), s, dtype=torch.int32, device=cuda)

    def run(b):
        return moe_mod.moe_ffn_quant(
            xg, b["w_gate"], b["w_up"], b["w_down"], b["w_gate_scale"],
            b["w_up_scale"], b["w_down_scale"], slots, act=full.act,
            out_dtype=torch.float32)
    old = {k: v.clone() for k, v in bufs.items()}
    y_old = run(bufs)                         # enqueued, maybe in flight
    cache.evict((0, 0))
    cache.prefetch([(0, 2)])
    assert int(cache.slot_of[0, 2]) == s      # the freed slot is reused
    y_new = run(cache.commit())
    torch.cuda.synchronize()
    want_old = run(old)
    new = {k: v.clone() for k, v in cache.bufs.items()}
    img = store.wire_expert(0, 2)
    for k, v in img.items():
        assert torch.equal(new[k][s].cpu(), v)
    assert torch.equal(y_old, want_old)
    assert torch.equal(y_new, run(new))
    assert not torch.equal(y_old, y_new)


def test_commit_ms_reads_each_commit_once_and_none_past_the_bound(
        cuda, monkeypatch):
    """The slot cache's commit timing on the card: a reading covers the
    commits since the last one (nothing staged: no commit, 0 ms), and past
    ``TIMED_COMMITS`` commits it is None, the next reading timed again."""
    from repro_torch.core import slot_cache as sc_mod
    monkeypatch.setattr(sc_mod, "TIMED_COMMITS", 3)
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    store = HostExpertStore(Model(cfg, device=cuda).init(3),
                            transfer_dtype="fp32")
    cache = ExpertSlotCache(store, n_slots=2)

    def swap(key):
        """Evict slot 0's expert, stage ``key`` (not resident) in its place
        and commit."""
        cache.evict(cache.key_of[0])
        assert cache.prefetch([key]) == 1
        cache.commit()
    cache.commit()
    assert cache.commit_ms() == 0.0
    cache.prefetch([(0, 0), (0, 1)])
    cache.commit()
    torch.cuda.synchronize()
    assert cache.commit_ms() > 0.0
    assert cache.commit_ms() == 0.0
    for n in (3, 4):
        for j in range(n):
            swap((0, 2 + j % 2))
        torch.cuda.synchronize()
        ms = cache.commit_ms()
        assert (ms is None) == (n > 3), (n, ms)
    swap((1, 0))
    torch.cuda.synchronize()
    assert cache.commit_ms() > 0.0


@pytest.mark.parametrize("wire", ["fp32", "fp16", "int8"])
def test_streaming_server_on_card_matches_cpu(cuda, wire):
    """rf=0.5 through the slot runtime on the card (B1 or B2 over slot
    buffers, real uploads on the copy stream) against the same weights on
    the CPU: equal tokens and slot counters."""
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    gpu = Model(cfg, device=cuda).init(3)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (3, 9))

    def serve(model, device):
        srv = TorchModelServer(
            EngineConfig(arch=cfg, gpu_cache_experts=3, dram_cache_experts=6,
                         resident_fraction=0.5, transfer_dtype=wire),
            copy.deepcopy(model), cache_len=32, device=device)
        return srv.generate(prompts.astype(np.int32), 6)
    g_out, g_stats = serve(gpu, cuda)
    c_out, c_stats = serve(cpu, "cpu")
    np.testing.assert_array_equal(g_out, c_out)
    assert g_stats["demand_uploads"] == c_stats["demand_uploads"] > 0
    assert g_stats["upload_bytes"] == c_stats["upload_bytes"]


def test_launcher_online_eamc_warm_restart_on_card(cuda, tmp_path):
    """The launcher on the card at rf 0.5 over int8 with ``--eamc-online
    --eamc-path``: the cold run learns and persists the collection, the
    warm run loads it (``source=load``) and serves the same tokens through
    B2 and B3; the cold run's EAMC line is the CPU's on the same weights."""
    import contextlib
    import io
    import re
    from repro_torch.launch import serve as serve_mod
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    gpu = Model(cfg, device=cuda).init(4)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})

    def run(model, device, home):
        args = serve_mod.parse_args([
            "--requests", "4", "--seed", "3", "--device", device,
            "--resident-fraction", "0.5", "--transfer-dtype", "int8",
            "--eamc-online", "--eamc-path", str(home / "eamc")])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = serve_mod.serve(args, cfg, copy.deepcopy(model))
        eamc = re.search(r"^eamc: source=.*$", buf.getvalue(), re.M)
        return out["tokens"], eamc.group(0)
    b2, b3 = moe_mod.quant_launches, fd_mod.launches
    (tmp_path / "card").mkdir()
    (tmp_path / "cpu").mkdir()
    cold, cold_line = run(gpu, "cuda", tmp_path / "card")
    assert moe_mod.quant_launches > b2 and fd_mod.launches > b3
    warm, warm_line = run(gpu, "cuda", tmp_path / "card")
    assert cold_line.startswith("eamc: source=cold ")
    assert warm_line.startswith("eamc: source=load ")
    assert cold == warm and all(len(t) for t in cold.values())
    assert (tmp_path / "card/eamc.npz").exists()
    assert run(cpu, "cpu", tmp_path / "cpu") == (cold, cold_line)


# DeepSeek-V2's expert FFN at decode: 160 experts, capacity 6, d_model 5120,
# d_expert 1536, a pool of 4 tokens each routed to 6 distinct experts
DEEPSEEK_DECODE = dict(E=160, C=6, d=5120, f=1536, tokens=4, top_k=6)


def _decode_occupancy_xg(gen, dtype, dev, E, C, d, tokens, top_k, **_):
    """xg (E, C, d) as the dispatch fills it for a pool of ``tokens``
    tokens, each routed to ``top_k`` distinct experts (a seeded draw) at
    its expert's first free row; every other row is exactly zero.
    -> (xg, (E, C) bool mask of the routed rows)."""
    x = torch.randn((tokens, d), generator=gen, device=dev).to(dtype)
    xg = torch.zeros((E, C, d), dtype=dtype, device=dev)
    fill = [0] * E
    for t in range(tokens):
        for e in torch.randperm(E, generator=gen, device=dev)[:top_k].tolist():
            xg[e, fill[e]] = x[t]
            fill[e] += 1
    return xg, (xg != 0).any(-1)


def _randn(gen, shape, std, dtype, dev):
    return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)


def test_moe_ffn_kernel_at_deepseek_decode(cuda):
    """B1 in bf16 at DeepSeek-V2's decode shape: the plain version's
    result, and every unrouted row +0.0."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    E, d, f = (DEEPSEEK_DECODE[k] for k in ("E", "d", "f"))
    xg, routed = _decode_occupancy_xg(gen, torch.bfloat16, cuda,
                                      **DEEPSEEK_DECODE)
    wg, wu = (_randn(gen, (E, d, f), d ** -0.5, torch.bfloat16, cuda)
              for _ in range(2))
    wd = _randn(gen, (E, f, d), f ** -0.5, torch.bfloat16, cuda)
    y = moe_mod.moe_ffn(xg, wg, wu, wd, act="swiglu")
    want = ref.moe_ffn_ref(xg, wg, wu, wd, act="swiglu")
    np.testing.assert_allclose(_f32(y), _f32(want), **_tol("bfloat16"))
    assert _bits_zero(y[~routed])
    assert not bool((y[routed] == 0).all(dim=-1).any())


@pytest.mark.parametrize("wire", ["int8", "fp16"])
def test_moe_ffn_quant_kernel_at_deepseek_decode(cuda, wire):
    """B2 at DeepSeek-V2's decode shape over 240 slots (rf 0.5 of 3 MoE
    layers x 160 experts) through a table of 160 distinct slots, x bf16,
    fp32 out as on the streaming path: the plain version's result, and
    every unrouted row +0.0."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    E, d, f, n = (*(DEEPSEEK_DECODE[k] for k in ("E", "d", "f")), 240)
    xg, routed = _decode_occupancy_xg(gen, torch.bfloat16, cuda,
                                      **DEEPSEEK_DECODE)

    def slots(shape):
        std = shape[0] ** -0.5
        if wire == "fp16":
            return _randn(gen, (n,) + shape, std, torch.float16, cuda), None
        q = torch.randint(-127, 128, (n,) + shape, generator=gen,
                          device=cuda, dtype=torch.int8)
        return q, (torch.rand((n, shape[-1]), generator=gen, device=cuda)
                   + 0.5) * (2 * std / 127)
    (wg, sg), (wu, su), (wd, sd) = slots((d, f)), slots((d, f)), slots((f, d))
    ids = torch.randperm(n, generator=gen, device=cuda)[:E].to(torch.int32)
    args = (xg, wg, wu, wd, sg, su, sd, ids)
    y = moe_mod.moe_ffn_quant(*args, act="swiglu", out_dtype=torch.float32)
    want = ref.moe_ffn_quant_ref(*args, act="swiglu",
                                 out_dtype=torch.float32)
    np.testing.assert_allclose(_f32(y), _f32(want), **_tol("float32"))
    assert _bits_zero(y[~routed])
    assert not bool((y[routed] == 0).all(dim=-1).any())


def _deepseek_reduced():
    """deepseek-v2-236b reduced to 1 dense + 2 MoE layers of 8 experts."""
    cfg = get_config("deepseek-v2-236b").reduced()
    return dataclasses.replace(
        cfg, n_layers=3, moe=dataclasses.replace(cfg.moe, n_experts=8))


def test_deepseek_model_on_card_matches_cpu(cuda):
    """Reduced DeepSeek-V2 (MLA, shared experts, a dense first layer) in
    fp32 on the card against the same weights on the CPU: forward logits
    and counts, then 4 pooled decode steps with a row retired halfway.
    B1 runs once per MoE layer per call; MLA decode never reaches B3."""
    cfg = _deepseek_reduced()
    gpu = Model(cfg, device=cuda).init(3)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)))
    n_moe = len(gpu.moe_layers)
    moe_before, fd_before = moe_mod.launches, fd_mod.launches
    with torch.inference_mode():
        lg, ag = gpu.forward({"tokens": toks.to(cuda)})
        lc, ac = cpu.forward({"tokens": toks})
        np.testing.assert_allclose(_f32(lg), lc.numpy(), atol=1e-4,
                                   rtol=1e-4)
        assert torch.equal(ag["counts"].cpu(), ac["counts"])
        caches = [m.init_cache(2, 32) for m in (gpu, cpu)]
        outs = [m.prefill({"tokens": toks.to(m.device)}, c)
                for m, c in zip((gpu, cpu), caches)]
        tok = [o[0].argmax(-1) for o in outs]
        for i in range(4):
            active = torch.tensor([True, i < 2])
            outs = [m.serve_step(c, t.to(m.device), active=active.to(m.device))
                    for m, c, t in zip((gpu, cpu), caches, tok)]
            np.testing.assert_allclose(_f32(outs[0][0]), _f32(outs[1][0]),
                                       atol=1e-4, rtol=1e-4)
            assert torch.equal(outs[0][2]["counts"].cpu(),
                               outs[1][2]["counts"])
            tok = [o[0].argmax(-1) for o in outs]
            assert torch.equal(tok[0].cpu(), tok[1])
        for g, c in zip(caches[0]["layers"], caches[1]["layers"]):
            for key in ("ckv", "kr"):
                np.testing.assert_allclose(_f32(g[key]), _f32(c[key]),
                                           atol=1e-4, rtol=1e-4)
    assert moe_mod.launches - moe_before == n_moe * (1 + 1 + 4)
    assert fd_mod.launches == fd_before


def test_deepseek_decode_step_never_launches_flash_decode(cuda):
    """One pooled DeepSeek-V2 decode step on the card: B1 once per MoE
    layer, B3 not at all (MLA decode is tensor ops over the latent
    cache)."""
    cfg = _deepseek_reduced()
    model = Model(cfg, device=cuda).init(4)
    with torch.inference_mode():
        cache = model.init_cache(4, 16)
        tok = torch.arange(4, device=cuda)
        moe_before, fd_before = moe_mod.launches, fd_mod.launches
        logits, cache, _ = model.serve_step(cache, tok)
        torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    assert fd_mod.launches == fd_before
    assert moe_mod.launches - moe_before == len(model.moe_layers)


def _wkv_inputs(rng, BH, T, hd, dtype, w_dtype, dev):
    r, k, v = (_rand(rng, (BH, T, hd), 0.5, dtype, dev) for _ in "rkv")
    w = torch.sigmoid(_rand(rng, (BH, T, hd), 1.0, "float32", dev))
    return (r, k, v, w.to(DTYPES[w_dtype]),
            _rand(rng, (BH, hd), 0.1, "float32", dev),
            _rand(rng, (BH, hd, hd), 0.1, "float32", dev))


# decode (4 rows x 64 heads, T = 1), prefill (64 heads, T = 512), ragged
@pytest.mark.parametrize("BH,T,hd", [(256, 1, 64), (64, 512, 64),
                                     (3, 37, 32)])
@pytest.mark.parametrize("dtype,w_dtype", [("float32", "float32"),
                                           ("bfloat16", "float32"),
                                           ("bfloat16", "bfloat16")])
def test_wkv6_kernel_matches_plain(cuda, BH, T, hd, dtype, w_dtype):
    rng = np.random.default_rng(8)
    args = _wkv_inputs(rng, BH, T, hd, dtype, w_dtype, cuda)
    before = wkv_mod.launches
    o, sN = wkv_mod.wkv6(*args)
    assert wkv_mod.launches == before + 1
    assert o.dtype == DTYPES[dtype] and sN.dtype == torch.float32
    o_ref, sN_ref = ref.wkv6_ref(*args)
    # fp32: the limit of tests/test_kernels.py's wkv6 test (sums over K in
    # another order); o in bf16 rounds once at the end
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_f32(o), _f32(o_ref),
                               **(tol if dtype == "float32" else _tol(dtype)))
    np.testing.assert_allclose(_f32(sN), _f32(sN_ref), **tol)


@pytest.mark.parametrize("T", [1, 7, 37, 512, 1000])
@pytest.mark.parametrize("BH", [1, 3, 64, 256, 300])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_kernel_splits_state(cuda, T, BH, hd, dtype):
    """B4 under both of ``plan``'s state splits (8 rows x 16 columns, and
    16 x 32 once B*H fills the card: BH = 256 at hd = 64, 300 at hd = 32)
    over single steps, tiles of steps that do not divide T, and long
    prompts: o and sN against the plain version."""
    rng = np.random.default_rng(17)
    args = _wkv_inputs(rng, BH, T, hd, dtype, "float32", cuda)
    o, sN = wkv_mod.wkv6(*args)
    o_ref, sN_ref = ref.wkv6_ref(*args)
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_f32(o), _f32(o_ref),
                               **(tol if dtype == "float32" else _tol(dtype)))
    np.testing.assert_allclose(_f32(sN), _f32(sN_ref), **tol)


def test_wkv6_wrapper_validates_inputs(cuda):
    rng = np.random.default_rng(9)
    r, k, v, w, u, s0 = _wkv_inputs(rng, 2, 3, 64, "float32", "float32",
                                    cuda)
    with pytest.raises(ValueError, match="on cpu"):
        wkv_mod.wkv6(r, k, v, w, u, s0.cpu())
    with pytest.raises(TypeError, match="fp32/bf16"):
        wkv_mod.wkv6(r.half(), k.half(), v.half(), w, u, s0)
    with pytest.raises(TypeError, match="w must be"):
        wkv_mod.wkv6(r, k, v, w.to(torch.bfloat16), u, s0)
    with pytest.raises(TypeError, match="dtype"):
        wkv_mod.wkv6(r, k, v, w, u.double(), s0)
    with pytest.raises(ValueError, match="contiguous"):
        wkv_mod.wkv6(r, k.transpose(0, 1).contiguous().transpose(0, 1), v,
                     w, u, s0)
    r48, k48, v48, w48, u48, s48 = _wkv_inputs(rng, 2, 3, 48, "float32",
                                               "float32", cuda)
    with pytest.raises(ValueError, match="hd in"):
        wkv_mod.wkv6(r48, k48, v48, w48, u48, s48)


def test_rwkv_model_on_card_matches_cpu(cuda):
    """Reduced rwkv6-7b in fp32 on the card (B4) against the same weights
    on the CPU (plain version): forward logits, prefill, and greedy tokens
    of a pooled decode with a row retired halfway; B4 runs once per layer
    per forward, prefill and decode step."""
    cfg = get_config("rwkv6-7b").reduced()
    gpu = Model(cfg, device=cuda).init(3)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 37)))
    before = wkv_mod.launches
    with torch.inference_mode():
        lg, _ = gpu.forward({"tokens": toks.to(cuda)})
        lc, _ = cpu.forward({"tokens": toks})
        np.testing.assert_allclose(_f32(lg), lc.numpy(), atol=1e-4,
                                   rtol=1e-4)
        caches = [m.init_cache(2, 8) for m in (gpu, cpu)]
        outs = [m.prefill({"tokens": toks.to(m.device)}, c)
                for m, c in zip((gpu, cpu), caches)]
        tok = [o[0].argmax(-1) for o in outs]
        for i in range(8):
            active = torch.tensor([True, i < 4])
            outs = [m.serve_step(c, t.to(m.device), active=active.to(m.device))
                    for m, c, t in zip((gpu, cpu), caches, tok)]
            tok = [o[0].argmax(-1) for o in outs]
            assert torch.equal(tok[0].cpu(), tok[1])
            np.testing.assert_allclose(_f32(outs[0][0]), _f32(outs[1][0]),
                                       atol=1e-4, rtol=1e-4)
        for lg_, lc_ in zip(caches[0]["layers"], caches[1]["layers"]):
            np.testing.assert_allclose(_f32(lg_["state"]), _f32(lc_["state"]),
                                       atol=1e-4, rtol=1e-4)
    assert wkv_mod.launches - before == cfg.n_layers * (1 + 1 + 8)


def _scan_inputs(rng, B, T, D, N, dtype, dev):
    """B5's operands as a Mamba layer makes them: dt = softplus(N(0, 1))
    fp32, A = -(1..N) per channel fp32, x/B/C N(0, 1) in ``dtype``, h0
    N(0, 0.5^2) fp32."""
    dt = torch.nn.functional.softplus(_rand(rng, (B, T, D), 1.0, "float32",
                                            dev))
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=dev).expand(D, N).contiguous()
    return (_rand(rng, (B, T, D), 1.0, dtype, dev), dt, A,
            _rand(rng, (B, T, N), 1.0, dtype, dev),
            _rand(rng, (B, T, N), 1.0, dtype, dev),
            _rand(rng, (B, D, N), 0.5, "float32", dev))


# Jamba's decode (a pool of 4, d_in 16384, N 16) and prefill (B = 1, up
# to 2048 steps), reduced Jamba's N = 8 (4 states a lane), and ragged
# shapes: T not a multiple of the 8 steps a lane takes at once, on either
# side of a 64-step ring stage (64, 65), d_in not a multiple of a block's
# 32 channels, and d_in 16383 (bf16 rows not 16-byte aligned: the
# plain-load staging)
@pytest.mark.parametrize("B,T,D,N", [(4, 1, 16384, 16), (1, 32, 16384, 16),
                                     (2, 40, 512, 8), (3, 7, 1000, 16),
                                     (1, 300, 1000, 16), (2, 1, 100, 8),
                                     (1, 33, 70, 16), (2, 9, 16383, 16),
                                     (2, 5, 16383, 8), (3, 40, 1000, 8),
                                     (1, 64, 1000, 16), (1, 65, 1000, 16),
                                     (1, 65, 1000, 8),
                                     (1, 2048, 16384, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_kernel_matches_plain(cuda, B, T, D, N, dtype):
    """B5 against ``selective_scan_ref`` on the same inputs: both widen x,
    B and C to fp32 and run the scan in fp32, so bf16 inputs hold the fp32
    limit too (sums over N in another order, exp to within an ulp, carried
    through T steps of a decaying state)."""
    rng = np.random.default_rng(12)
    args = _scan_inputs(rng, B, T, D, N, dtype, cuda)
    before = scan_mod.launches
    y, hT = scan_mod.selective_scan(*args)
    assert scan_mod.launches == before + 1
    assert y.dtype == hT.dtype == torch.float32
    y_ref, hT_ref = ref.selective_scan_ref(*args)
    np.testing.assert_allclose(_f32(y), _f32(y_ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_f32(hT), _f32(hT_ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,T,D,N", [(4, 1, 16384, 16), (1, 65, 1000, 16)])
def test_selective_scan_kernel_is_deterministic(cuda, B, T, D, N):
    """Two launches on the same inputs give bit-equal y and h_T: y's sum
    over a channel's states is a fixed-order shuffle butterfly."""
    rng = np.random.default_rng(14)
    args = _scan_inputs(rng, B, T, D, N, "bfloat16", cuda)
    y1, hT1 = scan_mod.selective_scan(*args)
    y2, hT2 = scan_mod.selective_scan(*args)
    assert torch.equal(y1, y2) and torch.equal(hT1, hT2)


def test_selective_scan_wrapper_validates_inputs(cuda):
    rng = np.random.default_rng(13)
    x, dt, A, Bm, Cm, h0 = _scan_inputs(rng, 2, 3, 96, 16, "float32", cuda)
    with pytest.raises(ValueError, match="on cpu"):
        scan_mod.selective_scan(x, dt, A, Bm, Cm, h0.cpu())
    with pytest.raises(TypeError, match="fp32/bf16"):
        scan_mod.selective_scan(x.half(), dt, A, Bm.half(), Cm.half(), h0)
    with pytest.raises(TypeError, match="dtype"):
        scan_mod.selective_scan(x, dt.to(torch.bfloat16), A, Bm, Cm, h0)
    with pytest.raises(TypeError, match="dtype"):
        scan_mod.selective_scan(x, dt, A, Bm.to(torch.bfloat16), Cm, h0)
    with pytest.raises(ValueError, match="contiguous"):
        scan_mod.selective_scan(x, dt, A, Bm, Cm,
                                h0.transpose(1, 2).contiguous()
                                .transpose(1, 2))
    x6, dt6, A6, B6, C6, h6 = _scan_inputs(rng, 2, 3, 96, 6, "float32", cuda)
    with pytest.raises(ValueError, match="N in"):
        scan_mod.selective_scan(x6, dt6, A6, B6, C6, h6)
    with pytest.raises(ValueError, match="CUDA tensors"):
        scan_mod.selective_scan(*(t.cpu() for t in (x, dt, A, Bm, Cm, h0)))


def _jamba_variant():
    """(mamba, dense), (mamba, MoE), (attn, dense), (mamba, MoE) with 8
    experts: a (mamba, MoE) block, and slots that miss at rf 0.5."""
    cfg = get_config("jamba-1.5-large-398b").reduced(n_layers=4)
    return dataclasses.replace(
        cfg, attn_layer_period=4, attn_layer_offset=2,
        moe=dataclasses.replace(cfg.moe, n_experts=8))


def test_jamba_model_on_card_matches_cpu(cuda):
    """Reduced Jamba in fp32 on the card (B5, B1, B3) against the same
    weights on the CPU (plain versions): forward logits and counts, exact
    prefills into a pool, and greedy tokens of a gated decode with a row
    retired halfway, whose conv/ssm rows then stay bit-frozen; B5 runs once
    per Mamba layer per forward, prefill and decode step."""
    cfg = _jamba_variant()
    gpu = Model(cfg, device=cuda).init(3)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    n_mamba = sum(d.kind == "mamba" for d in gpu.descs)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 13)))
    before = scan_mod.launches
    with torch.inference_mode():
        lg, ag = gpu.forward({"tokens": toks.to(cuda)})
        lc, ac = cpu.forward({"tokens": toks})
        np.testing.assert_allclose(_f32(lg), lc.numpy(), atol=1e-4,
                                   rtol=1e-4)
        assert torch.equal(ag["counts"].cpu(), ac["counts"])
        pools = [m.init_cache(2, 32) for m in (gpu, cpu)]
        tok = [torch.zeros(2, dtype=torch.long) for _ in range(2)]
        for slot, S in enumerate((9, 14)):
            prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S)))
            for i, (m, pool) in enumerate(zip((gpu, cpu), pools)):
                logits, one, _ = m.prefill({"tokens": prompt.to(m.device)},
                                           m.init_cache(1, 32))
                m.write_slot(pool, one, slot)
                tok[i][slot] = int(logits[0].argmax())
        assert torch.equal(tok[0], tok[1])
        frozen = None
        for i in range(8):
            active = torch.tensor([True, i < 4])
            if i == 4:
                frozen = [{k: v[1].clone() for k, v in layer.items()}
                          for layer in pools[0]["layers"]]
            outs = [m.serve_step(c, t.to(m.device), active=active.to(m.device))
                    for m, c, t in zip((gpu, cpu), pools, tok)]
            tok = [torch.where(active, o[0].argmax(-1).cpu(), t)
                   for o, t in zip(outs, tok)]
            assert torch.equal(tok[0], tok[1])
            np.testing.assert_allclose(_f32(outs[0][0]), _f32(outs[1][0]),
                                       atol=1e-4, rtol=1e-4)
        for layer, old in zip(pools[0]["layers"], frozen):
            for key in old:
                assert torch.equal(layer[key][1], old[key])
        for lg_, lc_ in zip(pools[0]["layers"], pools[1]["layers"]):
            if "ssm" in lg_:
                np.testing.assert_allclose(_f32(lg_["ssm"]), _f32(lc_["ssm"]),
                                           atol=1e-4, rtol=1e-4)
    assert scan_mod.launches - before == n_mamba * (1 + 2 + 8)


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_jamba_streaming_server_on_card_matches_cpu(cuda, wire):
    """The reduced Jamba variant at rf 0.5 through the slot runtime on the
    card against the CPU: exact-length prefills, equal tokens and slot
    counters, at least one demand upload."""
    cfg = _jamba_variant()
    gpu = Model(cfg, device=cuda).init(4)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (3, 9))

    def serve(model, device):
        srv = TorchModelServer(
            EngineConfig(arch=cfg, gpu_cache_experts=3, dram_cache_experts=6,
                         resident_fraction=0.5, transfer_dtype=wire),
            copy.deepcopy(model), cache_len=32, device=device)
        assert srv._bucket(9) == 9
        return srv.generate(prompts.astype(np.int32), 6)
    g_out, g_stats = serve(gpu, cuda)
    c_out, c_stats = serve(cpu, "cpu")
    np.testing.assert_array_equal(g_out, c_out)
    assert g_stats["demand_uploads"] == c_stats["demand_uploads"] > 0
    assert g_stats["upload_bytes"] == c_stats["upload_bytes"]


# ---------------------------------------------------------------------------
# training: B1 under a gradient, the other kernels refuse one
# ---------------------------------------------------------------------------


def _grad_close(got, want, dtype):
    """A gradient (E, ...) held per expert as a whole, ||got_e - want_e||
    <= rtol ||want_e|| (chip_smoke.py's ``compare_grad``): an element sums
    products whose rounded factors can sit near a zero of the activation's
    derivative, so its error does not scale with its own value, while a
    wrong row or expert moves its expert's norm. fp32 takes the kernel's
    rtol; bf16 1.5e-2, between sound readings (~4e-3) and a dropped row.
    An expert whose gradient is zero must get exactly zero."""
    rtol = 1.5e-2 if dtype == "bfloat16" else _tol(dtype)["rtol"]
    g, w = _f32(got), _f32(want)
    assert np.all(np.isfinite(g))
    g, w = g.reshape(len(g), -1), w.reshape(len(w), -1)
    err = np.linalg.norm(g - w, axis=1)
    assert np.all(err <= rtol * np.linalg.norm(w, axis=1)), err


@pytest.mark.parametrize("E,C,d,f", [(16, 41, 4096, 1536),  # the train C
                                     (3, 13, 520, 700)])     # ragged
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_moe_ffn_function_gradients_match_plain(cuda, E, C, d, f, dtype,
                                                act):
    """``MoEFFN`` (B1 on the graph): the output bit-equal to the plain
    launch under inference_mode (one launch a call), and the output and
    all four gradients against autograd through ``moe_ffn_ref``, with
    unrouted rows and an empty expert."""
    rng = np.random.default_rng(11)
    xg = _rand(rng, (E, C, d), 1.0, dtype, cuda)
    xg[0, C // 2:] = 0
    xg[-1] = 0
    ws = [_rand(rng, (E, d, f), d ** -0.5, dtype, cuda)
          if act in ("swiglu", "geglu") else None,
          _rand(rng, (E, d, f), d ** -0.5, dtype, cuda),
          _rand(rng, (E, f, d), f ** -0.5, dtype, cuda)]
    dy = _rand(rng, (E, C, d), 1.0, dtype, cuda)
    with torch.inference_mode():
        before = moe_mod.launches
        y = moe_mod.MoEFFN.apply(xg, *ws, act)
        assert moe_mod.launches == before + 1
        assert torch.equal(y, moe_mod.moe_ffn(xg, *ws, act=act))

    def leaves():
        return [None if t is None else t.clone().requires_grad_()
                for t in (xg, *ws)]
    got_in, want_in = leaves(), leaves()
    y = moe_mod.MoEFFN.apply(*got_in, act)
    y.backward(dy)
    want = ref.moe_ffn_ref(*want_in, act=act)
    want.backward(dy)
    np.testing.assert_allclose(_f32(y.detach()), _f32(want.detach()),
                               **_tol(dtype))
    for a, b in zip(got_in, want_in):
        if a is not None:
            _grad_close(a.grad, b.grad, dtype)


def test_kernels_without_a_backward_raise_under_grad(cuda):
    """B2, B3 and the raw B1, B4 and B5 launches write their outputs
    through pointers, off the autograd graph: asked for a gradient they
    raise, and under no_grad they run (B1, B4 and B5 take a gradient only
    through their autograd Functions, which ``ops`` picks)."""
    from repro_torch.kernels import ops
    x = torch.zeros(2, 4, 8, device=cuda, requires_grad=True)
    w = torch.zeros(2, 8, 16, device=cuda)
    wd = torch.zeros(2, 16, 8, device=cuda)
    with pytest.raises(NotImplementedError, match="moe_ffn has no backward"):
        moe_mod.moe_ffn(x, w, w, wd)
    with pytest.raises(NotImplementedError, match="moe_ffn_quant"):
        ops.moe_expert_ffn_slots(
            x, {"w_gate": w.half(), "w_up": w.half(), "w_down": wd.half()},
            torch.arange(2, dtype=torch.int32, device=cuda))
    q = torch.zeros(1, 4, 64, device=cuda, requires_grad=True)
    kv = torch.zeros(1, 16, 2, 64, device=cuda)
    with pytest.raises(NotImplementedError, match="flash_decode"):
        fd_mod.flash_decode(q, kv, kv, 16)
    r = torch.zeros(2, 3, 64, device=cuda, requires_grad=True)
    u, s0 = torch.zeros(2, 64, device=cuda), torch.zeros(2, 64, 64,
                                                         device=cuda)
    with pytest.raises(NotImplementedError, match="wkv6"):
        wkv_mod.wkv6(r, r, r, r, u, s0)
    xs = torch.zeros(1, 3, 32, device=cuda, requires_grad=True)
    dt = torch.zeros(1, 3, 32, device=cuda)
    A, h0 = torch.zeros(32, 16, device=cuda), torch.zeros(1, 32, 16,
                                                          device=cuda)
    bc = torch.zeros(1, 3, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="selective_scan"):
        scan_mod.selective_scan(xs, dt, A, bc, bc, h0)
    with torch.no_grad():
        ops.wkv_scan(r, r, r, r, u, s0)
        ops.selective_scan(xs, dt, A, bc, bc, h0)
        moe_mod.moe_ffn(x, w, w, wd)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-236b"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_model_loss_on_card_reaches_every_parameter(cuda, arch, policy):
    """``Model.loss`` on the card (B1 through ``MoEFFN``, remat on under
    either policy) gives every parameter a finite gradient, non-zero on the
    experts, equal to the CPU's within fp32 limits; B1 launches once a MoE
    layer, plus its recompute in a scan group."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              remat_policy=policy)
    gpu = Model(cfg, device=cuda).init(4).trainable()
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    cpu.trainable()
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (2, 16)))
    before = moe_mod.launches
    lg = gpu.loss({"tokens": toks.to(cuda)}, remat=True)
    lg.backward()
    torch.cuda.synchronize()
    assert moe_mod.launches - before == sum(
        2 if i >= gpu.n_prefix else 1 for i in gpu.moe_layers)
    lc = cpu.loss({"tokens": toks}, remat=True)
    lc.backward()
    np.testing.assert_allclose(float(lg.detach()), float(lc.detach()),
                               rtol=1e-5)
    cpu_grads = dict(cpu.named_parameters())
    for n, p in gpu.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), n
        if ".moe.w_" in n and "router" not in n:
            assert bool(p.grad.any()), n
        # fp32 limits, atol scaled by the gradient's RMS (its scale is the
        # loss's, over sums of many products)
        want = cpu_grads[n].grad.numpy()
        np.testing.assert_allclose(
            _f32(p.grad), want, rtol=1e-4, err_msg=n,
            atol=2e-5 * float(np.sqrt(np.mean(want * want))))


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-236b"])
def test_grouped_dispatch_on_card_runs_b1_and_matches_cpu(cuda, arch):
    """``moe_dispatch="grouped"`` on the card: the loss and every gradient
    equal the CPU's within fp32 limits, and each MoE layer's expert FFN is
    one B1 launch a forward (its recompute in a scan group) over every
    sequence's blocks, through ``MoEFFN``'s backward."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              moe_dispatch="grouped")
    gpu = Model(cfg, device=cuda).init(6).trainable()
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    cpu.trainable()
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (3, 16)))
    before = moe_mod.launches
    lg = gpu.loss({"tokens": toks.to(cuda)}, remat=True)
    lg.backward()
    torch.cuda.synchronize()
    assert moe_mod.launches - before == sum(
        2 if i >= gpu.n_prefix else 1 for i in gpu.moe_layers)
    lc = cpu.loss({"tokens": toks}, remat=True)
    lc.backward()
    np.testing.assert_allclose(float(lg.detach()), float(lc.detach()),
                               rtol=1e-5)
    cpu_grads = dict(cpu.named_parameters())
    for n, p in gpu.named_parameters():
        want = cpu_grads[n].grad.numpy()
        np.testing.assert_allclose(
            _f32(p.grad), want, rtol=1e-4, err_msg=n,
            atol=2e-5 * float(np.sqrt(np.mean(want * want))))


def test_blocked_attention_on_card_matches_cpu(cuda):
    """``attn_impl="blocked"`` prefill of 1100 tokens (three query blocks,
    two KV blocks, past the reduced window) on the card equals the CPU's
    within fp32 limits and the card's naive prefill; no kernel runs."""
    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                              attn_impl="blocked")
    gpu = Model(cfg, device=cuda).init(7)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    naive = Model(dataclasses.replace(cfg, attn_impl="naive"), device=cuda)
    naive.load_state_dict(gpu.state_dict())
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (1, 1100)))
    before = (moe_mod.launches, fd_mod.launches)
    with torch.inference_mode():
        got = [m.prefill({"tokens": toks.to(m.device)},
                         m.init_cache(1, 1100))[0].cpu()
               for m in (gpu, naive, cpu)]
    assert (moe_mod.launches, fd_mod.launches) == before
    for other in got[1:]:
        np.testing.assert_allclose(got[0].numpy(), other.numpy(), rtol=1e-4,
                                   atol=1e-4)


# -- expert parallelism: D shards of one card --------------------------------

def _one_card_mesh(cuda, D):
    from repro_torch.launch.mesh import ExpertMesh
    return ExpertMesh([cuda] * D)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("act", ["swiglu", "relu2"])
def test_moe_ffn_sharded_bit_equal_on_card(cuda, D, act):
    """B1 shard by shard (E/D experts each, C = 6 padded to a multiple of
    D) gives the unsharded launch bit for bit, one launch a shard."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    E, C, d, f = 8, 6, 4096, 1536
    xg, _ = _decode_occupancy_xg(gen, torch.bfloat16, cuda, E=E, C=C, d=d,
                                 tokens=4, top_k=3)
    wg = _randn(gen, (E, d, f), d ** -0.5, torch.bfloat16, cuda) \
        if act == "swiglu" else None
    wu = _randn(gen, (E, d, f), d ** -0.5, torch.bfloat16, cuda)
    wd = _randn(gen, (E, f, d), f ** -0.5, torch.bfloat16, cuda)
    want = moe_mod.moe_ffn(xg, wg, wu, wd, act=act)
    before = moe_mod.launches
    got = moe_mod.moe_ffn_sharded(xg, wg, wu, wd, act=act,
                                  mesh=_one_card_mesh(cuda, D))
    assert moe_mod.launches == before + D
    assert torch.equal(got, want)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("wire", ["bf16", "int8", "fp16"])
def test_moe_ffn_sharded_slots_bit_equal_on_card(cuda, D, wire):
    """The runtime's exchange over per-shard slot buffers: each shard's
    buffers hold only its experts (B1 through the slot table over the
    master-dtype wire, B2 over int8/fp16); the result equals the unsharded
    slot launch bit for bit, and the shard kernel's counter rises by D."""
    from repro_torch.core.slot_cache import quantize_weight
    from repro_torch.kernels import ops
    gen = torch.Generator(device=cuda).manual_seed(12)
    E, C, d, f, n = 16, 8, 4096, 1536, 24
    xg, _ = _decode_occupancy_xg(gen, torch.bfloat16, cuda, E=E, C=C, d=d,
                                 tokens=4, top_k=8)
    bufs = {}
    for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                        ("w_down", (f, d))):
        w = _randn(gen, (n,) + shape, shape[0] ** -0.5, torch.bfloat16, cuda)
        if wire == "bf16":
            bufs[name] = w
            continue
        qs = [quantize_weight(w[i].cpu(), wire) for i in range(n)]
        bufs[name] = torch.stack([q for q, _ in qs]).to(cuda)
        if qs[0][1] is not None:
            bufs[name + "_scale"] = torch.stack([s for _, s in qs]).to(cuda)
    table = torch.randperm(n, generator=gen, device=cuda)[:E] \
        .to(torch.int32)
    out = torch.bfloat16 if wire == "bf16" else torch.float32
    want = ops.moe_expert_ffn_slots(xg, bufs, table, act="swiglu",
                                    out_dtype=out)
    Eb = E // D
    own = [{k: v.index_select(0, table[i * Eb:(i + 1) * Eb].long())
            for k, v in bufs.items()} for i in range(D)]
    rows = [torch.arange(Eb, dtype=torch.int32, device=cuda)] * D
    counter = "launches" if wire == "bf16" else "quant_launches"
    before = getattr(moe_mod, counter)
    got = moe_mod.moe_ffn_sharded_slots(xg, own, rows, act="swiglu",
                                        out_dtype=out,
                                        mesh=_one_card_mesh(cuda, D))
    assert getattr(moe_mod, counter) == before + D
    assert torch.equal(got, want)


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_sharded_server_on_card_matches_cpu(cuda, wire):
    """A D = 2 server on one card's two shards, rf 0.5, against the same
    weights over two logical CPU shards and against the card's D = 1:
    equal tokens and summed slot counters; the slot kernel launches twice
    a MoE layer and step."""
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    gpu = Model(cfg, device=cuda).init(3)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (3, 9))

    def serve(model, device, D, mesh=None):
        srv = TorchModelServer(
            EngineConfig(arch=cfg, gpu_cache_experts=3, dram_cache_experts=6,
                         resident_fraction=0.5, transfer_dtype=wire,
                         n_devices=D),
            copy.deepcopy(model), cache_len=32, device=device, mesh=mesh)
        n0 = moe_mod.launches + moe_mod.quant_launches
        out, stats = srv.generate(prompts.astype(np.int32), 6)
        n = moe_mod.launches + moe_mod.quant_launches - n0
        return out, stats, n, srv
    g_out, g_stats, n, srv = serve(gpu, cuda, 2, _one_card_mesh(cuda, 2))
    c_out, c_stats, _, _ = serve(cpu, "cpu", 2)
    one_out, _, _, _ = serve(gpu, cuda, 1)
    np.testing.assert_array_equal(g_out, c_out)
    np.testing.assert_array_equal(g_out, one_out)
    for key in ("demand_uploads", "prefetch_uploads", "upload_bytes",
                "slot_hits"):
        assert g_stats[key] == c_stats[key], key
    assert g_stats["n_devices"] == 2
    n_moe = len(gpu.moe_layers)
    assert n == 2 * n_moe * (srv.n_prefills + srv.n_decode_steps)


# ---------------------------------------------------------------------------
# B4 and B5 under a gradient: their autograd Functions and backward kernels
# ---------------------------------------------------------------------------


def _rows_close(got, want):
    """A gradient held per leading row as a whole (``_grad_close``'s
    normwise rule): the kernel and the plain backward both sum in fp32 from
    the same inputs, in another order, over T steps of a state, so an fp32
    gradient takes the fp32 rtol; a bf16 one is rounded once, 1.5e-2."""
    _grad_close(got, want, "bfloat16" if got.dtype == torch.bfloat16
                else "float32")


def _uniform(rng, shape, dev):
    return torch.from_numpy(rng.random(shape, np.float32)).to(dev)


def _wkv_grad_inputs(rng, BH, T, hd, dtype, w_dtype, dev, w_lo=0.0):
    """B4's inputs and its upstream gradients; ``w_lo`` > 0 puts w in
    [w_lo, 1) (near 1), else sigmoid(N(0, 1)) with a tenth of it exactly
    0 (an underflowed decay)."""
    r, k, v, w, u, s0 = _wkv_inputs(rng, BH, T, hd, dtype, "float32", dev)
    if w_lo:
        w = w_lo + (1 - w_lo) * _uniform(rng, w.shape, dev) * 0.999
    else:
        w = torch.where(_uniform(rng, w.shape, dev) < 0.1, 0.0, w)
    do = _rand(rng, (BH, T, hd), 1.0, dtype, dev)
    dsN = _rand(rng, (BH, hd, hd), 0.1, "float32", dev)
    return (r, k, v, w.to(DTYPES[w_dtype]), u, s0), do, dsN


# the training shape (4 rows x 64 heads, T = 128), T = 1, T across
# checkpoint chunks and tiles (37, 40), hd 32; one row and an odd BH, with a
# last chunk whose steps fill only part of its second 4-step half (14) or
# none of it (4, 12)
@pytest.mark.parametrize("BH,T,hd,w_lo", [(256, 128, 64, 0.0),
                                          (2, 1, 64, 0.0),
                                          (3, 37, 32, 0.0),
                                          (5, 40, 64, 0.9),
                                          (3, 17, 32, 0.99),
                                          (1, 14, 64, 0.0),
                                          (7, 4, 32, 0.0),
                                          (7, 12, 64, 0.9)])
@pytest.mark.parametrize("dtype,w_dtype", [("float32", "float32"),
                                           ("bfloat16", "float32"),
                                           ("bfloat16", "bfloat16")])
def test_wkv6_backward_kernel_matches_plain(cuda, BH, T, hd, w_lo, dtype,
                                            w_dtype):
    """``WKV6`` on the card: o and sN bit-equal to the serving launch (the
    checkpoints do not touch the arithmetic), the checkpoints the states
    of the plain forward, and every gradient (dr, dk, dv, dw, du, ds0)
    against ``wkv6_bwd_ref`` on the same inputs; one launch each way."""
    rng = np.random.default_rng(21)
    args, do, dsN = _wkv_grad_inputs(rng, BH, T, hd, dtype, w_dtype, cuda,
                                     w_lo)
    o0, sN0 = wkv_mod.wkv6(*args)
    o1, sN1, ck = wkv_mod.wkv6(*args, checkpoints=True)
    assert torch.equal(o0, o1) and torch.equal(sN0, sN1)
    assert torch.equal(ck[:, 0], args[5])
    if T > wkv_mod.CKPT_STEPS:
        c = wkv_mod.CKPT_STEPS
        _, s_c = ref.wkv6_ref(*(t[:, :c] for t in args[:4]), args[4],
                              args[5])
        np.testing.assert_allclose(_f32(ck[:, 1]), _f32(s_c), atol=1e-4,
                                   rtol=1e-4)
    leaves = [t.clone().requires_grad_() for t in args]
    before = (wkv_mod.launches, wkv_mod.bwd_launches)
    o, sN = wkv_mod.WKV6.apply(*leaves)
    torch.autograd.backward((o, sN), (do, dsN))
    assert (wkv_mod.launches, wkv_mod.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(o.detach(), o0)
    want = ref.wkv6_bwd_ref(*args, do, dsN)
    for t, g in zip(leaves, want):
        assert t.grad.dtype == t.dtype
        _rows_close(t.grad, g)


def test_wkv6_backward_kernel_is_deterministic(cuda):
    """Two backward launches on the same inputs give bit-equal gradients:
    every sum stays in one block, in a fixed order."""
    rng = np.random.default_rng(22)
    args, do, dsN = _wkv_grad_inputs(rng, 256, 128, 64, "bfloat16",
                                     "float32", cuda)
    _, _, ck = wkv_mod.wkv6(*args, checkpoints=True)
    g1 = wkv_mod.wkv6_backward(*args[:5], ck, do, dsN)
    g2 = wkv_mod.wkv6_backward(*args[:5], ck, do, dsN)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_wkv6_backward_wrapper_validates_inputs(cuda):
    rng = np.random.default_rng(23)
    args, do, dsN = _wkv_grad_inputs(rng, 2, 9, 64, "float32", "float32",
                                     cuda)
    r, k, v, w, u, _ = args
    _, _, ck = wkv_mod.wkv6(*args, checkpoints=True)
    with pytest.raises(ValueError, match="on cpu"):
        wkv_mod.wkv6_backward(r, k, v, w, u, ck, do, dsN.cpu())
    with pytest.raises(ValueError, match="ck has shape"):
        wkv_mod.wkv6_backward(r, k, v, w, u, ck[:, :1].contiguous(), do,
                              dsN)
    with pytest.raises(TypeError, match="do has dtype"):
        wkv_mod.wkv6_backward(r, k, v, w, u, ck, do.to(torch.bfloat16), dsN)
    with pytest.raises(TypeError, match="w must be"):
        wkv_mod.wkv6_backward(r, k, v, w.to(torch.bfloat16), u, ck, do, dsN)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wkv_mod.wkv6_backward(*(t.cpu() for t in (r, k, v, w, u, ck, do,
                                                   dsN)))
    with pytest.raises(NotImplementedError, match="wkv6_backward"):
        wkv_mod.wkv6_backward(r.clone().requires_grad_(), k, v, w, u, ck,
                              do, dsN)


def _scan_grad_inputs(rng, B, T, D, N, dtype, dev, big_dt=False):
    """B5's inputs, its upstream gradients; ``big_dt`` makes a third of
    dt 40-100, where exp(dt * A) underflows to 0 for every state."""
    args = list(_scan_inputs(rng, B, T, D, N, dtype, dev))
    if big_dt:
        big = 40 + 60 * _uniform(rng, args[1].shape, dev)
        args[1] = torch.where(_uniform(rng, args[1].shape, dev) < 1 / 3,
                              big, args[1])
    dy = _rand(rng, (B, T, D), 1.0, "float32", dev)
    dhT = _rand(rng, (B, D, N), 0.1, "float32", dev)
    return tuple(args), dy, dhT


# Jamba's training shape (B 4, T 128, d_in 16384, N 16), reduced Jamba's
# N = 8, T = 1, T across checkpoint chunks and ring stages (65), d_in not a
# multiple of a block's 32 channels, d_in 16383 (unaligned bf16 rows), and
# a dt large enough that exp(dt * A) underflows; ragged last blocks of 12
# channels (d_in 300: 10 blocks) and 8 (2056: 65 blocks)
@pytest.mark.parametrize("B,T,D,N,big_dt", [(4, 128, 16384, 16, False),
                                            (2, 40, 512, 8, False),
                                            (2, 1, 100, 8, False),
                                            (1, 65, 1000, 16, False),
                                            (2, 9, 16383, 16, False),
                                            (3, 33, 70, 16, True),
                                            (3, 13, 300, 16, False),
                                            (1, 20, 2056, 8, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_backward_kernel_matches_plain(cuda, B, T, D, N,
                                                      big_dt, dtype):
    """``SelectiveScan`` on the card: y and h_T bit-equal to the serving
    launch, the checkpoints the plain forward's states, and every gradient
    (dx, ddt, dA, dB, dC, dh0) against ``selective_scan_bwd_ref`` on the
    same inputs; one launch each way."""
    rng = np.random.default_rng(24)
    args, dy, dhT = _scan_grad_inputs(rng, B, T, D, N, dtype, cuda, big_dt)
    y0, h0 = scan_mod.selective_scan(*args)
    y1, h1, ck = scan_mod.selective_scan(*args, checkpoints=True)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    assert torch.equal(ck[0], args[5])
    if T > scan_mod.CKPT_STEPS:
        c = scan_mod.CKPT_STEPS
        x, dt, A, Bm, Cm, hh = args
        _, h_c = ref.selective_scan_ref(x[:, :c], dt[:, :c], A, Bm[:, :c],
                                        Cm[:, :c], hh)
        np.testing.assert_allclose(_f32(ck[1]), _f32(h_c), atol=1e-4,
                                   rtol=1e-4)
    leaves = [t.clone().requires_grad_() for t in args]
    before = (scan_mod.launches, scan_mod.bwd_launches)
    y, hT = scan_mod.SelectiveScan.apply(*leaves)
    torch.autograd.backward((y, hT), (dy, dhT))
    assert (scan_mod.launches, scan_mod.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(y.detach(), y0)
    want = ref.selective_scan_bwd_ref(*args, dy, dhT)
    for t, g in zip(leaves, want):
        assert t.grad.dtype == t.dtype and bool(torch.isfinite(t.grad).all())
        _rows_close(t.grad, g)


def test_selective_scan_backward_kernel_is_deterministic(cuda):
    """Two backward launches give bit-equal gradients: dB/dC sum per-block
    partials and dA per-row partials in a fixed order, with no atomics."""
    rng = np.random.default_rng(25)
    args, dy, dhT = _scan_grad_inputs(rng, 4, 128, 16384, 16, "bfloat16",
                                      cuda)
    _, _, ck = scan_mod.selective_scan(*args, checkpoints=True)
    g1 = scan_mod.selective_scan_backward(*args[:5], ck, dy, dhT)
    g2 = scan_mod.selective_scan_backward(*args[:5], ck, dy, dhT)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_selective_scan_backward_wrapper_validates_inputs(cuda):
    rng = np.random.default_rng(26)
    args, dy, dhT = _scan_grad_inputs(rng, 2, 9, 96, 16, "float32", cuda)
    x, dt, A, Bm, Cm, _ = args
    _, _, ck = scan_mod.selective_scan(*args, checkpoints=True)
    with pytest.raises(ValueError, match="on cpu"):
        scan_mod.selective_scan_backward(x, dt, A, Bm, Cm, ck, dy, dhT.cpu())
    with pytest.raises(ValueError, match="ck has shape"):
        scan_mod.selective_scan_backward(x, dt, A, Bm, Cm, ck[:1].contiguous(),
                                         dy, dhT)
    with pytest.raises(TypeError, match="dy has dtype"):
        scan_mod.selective_scan_backward(x, dt, A, Bm, Cm, ck,
                                         dy.to(torch.bfloat16), dhT)
    with pytest.raises(ValueError, match="CUDA tensors"):
        scan_mod.selective_scan_backward(*(t.cpu() for t in (
            x, dt, A, Bm, Cm, ck, dy, dhT)))
    with pytest.raises(NotImplementedError, match="selective_scan_backward"):
        scan_mod.selective_scan_backward(x.clone().requires_grad_(), dt, A,
                                         Bm, Cm, ck, dy, dhT)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_recurrent_loss_on_card_reaches_every_parameter(cuda, arch, policy):
    """``Model.loss`` of reduced RWKV6 / Jamba on the card (B4 / B5 through
    their Functions, remat on under either policy) gives every parameter a
    finite gradient equal to the CPU's within fp32 limits; the recurrent
    kernel launches forward once a layer plus its recompute in a scan
    group, and backward once a layer."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              remat_policy=policy)
    gpu = Model(cfg, device=cuda).init(5).trainable()
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    cpu.trainable()
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 19)))
    mod = wkv_mod if cfg.rwkv is not None else scan_mod
    kind = "rwkv" if cfg.rwkv is not None else "mamba"
    layers = [i for i in range(cfg.n_layers) if cfg.block_kind(i) == kind]
    before = (mod.launches, mod.bwd_launches)
    lg = gpu.loss({"tokens": toks.to(cuda)}, remat=True)
    lg.backward()
    torch.cuda.synchronize()
    assert (mod.launches - before[0], mod.bwd_launches - before[1]) == (
        sum(2 if i >= gpu.n_prefix else 1 for i in layers), len(layers))
    lc = cpu.loss({"tokens": toks}, remat=True)
    lc.backward()
    np.testing.assert_allclose(float(lg.detach()), float(lc.detach()),
                               rtol=1e-5)
    cpu_grads = dict(cpu.named_parameters())
    for n, p in gpu.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), n
        want = cpu_grads[n].grad.numpy()
        np.testing.assert_allclose(
            _f32(p.grad), want, rtol=1e-4, err_msg=n,
            atol=2e-5 * float(np.sqrt(np.mean(want * want))))
