"""B3's two halves over a head_dim-sharded cache (``kernels/decode_split``:
B3-qk, the partial scores of one head_dim slice, and B3-pv, the softmax of
the summed scores over one V slice) on the CPU: their plain versions, with
the scores of the slices summed as the all-reduce over the model axis sums
them, against ``flash_decode_ref`` and the reference's Pallas
``flash_decode`` in interpret mode; the dispatch, the wrappers' refusals
and the meta stand-ins. The CUDA kernels are held against these plain
versions on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``
phase 18a)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as pallas_flash_decode
from repro_torch.kernels import decode_split, meta, ops, ref
from repro_torch.launch import spmd

torch.set_num_threads(2)

# fp32 sums in another order: tests/test_kernels.py's fp32 limit
TOL = dict(atol=2e-5, rtol=1e-4)


def _inputs(B, H, Hkv, hd, S, seed, qscale=1.0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, hd, generator=g) * qscale
    k, v = (torch.randn(B, S, Hkv, hd, generator=g) for _ in "kv")
    return q, k, v


def _split(q, k, v, lens, cap, n, return_lse=False):
    """Decode over ``n`` head_dim slices: B3-qk on each slice, the scores
    summed (the all-reduce), B3-pv on each V slice, the slices' outputs
    side by side."""
    hd = q.shape[-1]
    w = hd // n
    sl = [slice(i * w, (i + 1) * w) for i in range(n)]
    scores = sum(ops.decode_scores(q[..., s].contiguous(),
                                   k[..., s].contiguous(), lens, hd ** -0.5)
                 for s in sl)
    parts = [ops.decode_values(scores, v[..., s].contiguous(), lens, cap,
                               return_lse=return_lse) for s in sl]
    if not return_lse:
        return torch.cat(parts, -1)
    for _, lse in parts[1:]:                   # every slice's lse is one
        assert torch.equal(lse, parts[0][1])
    return torch.cat([p[0] for p in parts], -1), parts[0][1]


# (B, H, Hkv, hd, S, lengths, softcap): GQA at qwen3-moe's 64/4 heads cut
# to 16/4, MQA, Gemma-2's hd 256 with its softcap over a ragged ring,
# Whisper's cross-attention at hd 64 (every position valid)
CASES = [(2, 16, 4, 128, 40, [40, 7], 0.0),
         (3, 8, 1, 128, 33, [1, 33, 20], 0.0),
         (2, 8, 4, 256, 50, [50, 3], 50.0),
         (2, 12, 12, 64, 30, [30, 30], 0.0)]


@pytest.mark.parametrize("n", [1, 2, 4, 16])
@pytest.mark.parametrize("case", CASES, ids=["gqa", "mqa", "softcap",
                                             "cross"])
def test_split_equals_flash_decode_ref(case, n):
    """The slices' B3-qk scores summed, then B3-pv over each V slice,
    equal ``flash_decode_ref`` over whole heads, with and without the
    log-sum-exp; B3-qk writes 0 past each row's length."""
    B, H, Hkv, hd, S, lens, cap = case
    q, k, v = _inputs(B, H, Hkv, hd, S, seed=n, qscale=8.0 if cap else 1.0)
    cl = torch.tensor(lens)
    want = ref.flash_decode_ref(q, k, v, cl, cap)
    torch.testing.assert_close(_split(q, k, v, cl, cap, n), want, **TOL)
    want_o, want_l = ref.flash_decode_ref(q, k, v, cl, cap, return_lse=True)
    out, lse = _split(q, k, v, cl, cap, n, return_lse=True)
    torch.testing.assert_close(out, want_o, **TOL)
    torch.testing.assert_close(lse, want_l, atol=1e-5, rtol=1e-6)
    s = ref.decode_scores_ref(q[..., :hd // n], k[..., :hd // n], cl,
                              hd ** -0.5)
    past = torch.arange(S)[None, None, :] >= cl[:, None, None]
    assert s.dtype == torch.float32 and s.shape == (B, H, S)
    assert bool((s[past.expand_as(s)] == 0).all())


@pytest.mark.parametrize("n", [2, 4])
def test_split_equals_pallas_flash_decode(n):
    """The split decode against the reference's Pallas ``flash_decode``
    (interpret mode) on the same numpy inputs, per-slot lengths."""
    rng = np.random.default_rng(n)
    B, H, Hkv, hd, S = 2, 8, 2, 64, 64
    q = rng.standard_normal((B, H, hd), np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, hd), np.float32)
            for _ in "kv")
    lens = np.array([64, 23], np.int32)
    want = pallas_flash_decode(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(lens),
                               block_s=32, interpret=True)
    got = _split(*(torch.from_numpy(a) for a in (q, k, v)),
                 torch.from_numpy(lens), 0.0, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_a_row_with_no_valid_position_gives_zero_and_minus_inf():
    """B3-pv over a row of length 0: out 0 and lse -inf, as B3's lse mode
    gives them; B3-qk's scores there are all 0; the split merges through
    ``spmd.merge_blocks`` as B3's blocks do."""
    q, k, v = _inputs(3, 8, 2, 64, 20, seed=3)
    cl = torch.tensor([0, 20, 0])
    out, lse = _split(q, k, v, cl, 0.0, 2, return_lse=True)
    want_o, want_l = ref.flash_decode_ref(q, k, v, cl, return_lse=True)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert bool((lse[[0, 2]] == -torch.inf).all())
    torch.testing.assert_close(out, want_o, **TOL)
    torch.testing.assert_close(lse[1], want_l[1], atol=1e-5, rtol=1e-6)
    assert not ref.decode_scores_ref(q, k, cl, 0.125)[[0, 2]].any()
    # two sequence blocks of the split decode, merged by their lse
    blocks = [_split(q, k[:, a:b], v[:, a:b], torch.clamp(cl - a, 0, b - a),
                     0.0, 2, return_lse=True) for a, b in ((0, 12),
                                                           (12, 20))]
    merged = spmd.merge_blocks(torch.stack([o for o, _ in blocks]),
                               torch.stack([s for _, s in blocks]))
    torch.testing.assert_close(merged[1], want_o[1], **TOL)


def test_bf16_inputs_take_fp32_sums():
    """bf16 q/K/V: the scores are fp32, the output is V's dtype and within
    bf16's limit of the fp32 computation on the same values."""
    q, k, v = (t.to(torch.bfloat16) for t in _inputs(2, 8, 2, 128, 24, 5))
    cl = torch.tensor([24, 9])
    s = ops.decode_scores(q[..., :64], k[..., :64], cl, 128 ** -0.5)
    assert s.dtype == torch.float32
    out = _split(q, k, v, cl, 0.0, 2)
    assert out.dtype == torch.bfloat16
    want = ref.flash_decode_ref(q.float(), k.float(), v.float(), cl)
    torch.testing.assert_close(out.float(), want, atol=5e-2, rtol=5e-2)


def test_wrappers_take_cuda_tensors_only():
    """The CUDA wrappers refuse CPU tensors (no fallback: the plain
    versions run only through ``ops`` for CPU tensors) and count nothing."""
    q, k, v = _inputs(1, 4, 1, 64, 8, 0)
    n = (decode_split.scores_launches, decode_split.values_launches)
    with pytest.raises(ValueError, match="CUDA"):
        decode_split.decode_scores(q, k, 8, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        decode_split.decode_values(torch.zeros(1, 4, 8), v, 8)
    assert (decode_split.scores_launches,
            decode_split.values_launches) == n


@pytest.mark.parametrize("B,Hkv,rep,S,want", [
    (4, 4, 16, 64, (1, 128)),
    # phase 18a's cache, qwen3-moe's 64 / 4 heads: half its rows are short
    (4, 4, 16, 32768, (64, 512)),
    # B = 1: a row alone, with one KV head and with qwen3-moe's four
    (1, 1, 16, 32768, (256, 128)),
    (1, 4, 16, 32768, (256, 128)),
    # more than 16 heads a group take a second M tile: twice the blocks
    (4, 4, 32, 32768, (32, 1024)),
    # a million positions: whole tiles of 1024
    (1, 1, 8, 2 ** 20, (1024, 1024))])
def test_splits_cut_whole_tiles(B, Hkv, rep, S, want):
    """B3-pv's split over S (132 SMs): whole tiles covering S, about
    ``BLOCKS_PER_SM`` blocks of work an SM when one split a row is too
    few."""
    n, L = decode_split.splits(B, Hkv, rep, S, 132)
    assert (n, L) == want
    assert L % decode_split.TILE == 0 and n * L >= S > (n - 1) * L
    blocks = B * Hkv * -(-rep // decode_split.HEADS)
    if L > decode_split.TILE:
        assert n * blocks <= decode_split.BLOCKS_PER_SM * 132 < \
            2 * n * blocks


def test_meta_stand_ins_count_a_launch_each():
    """On meta tensors ``ops`` takes the stand-ins: the output shapes and
    dtypes of the kernels, one launch each with its products."""
    seen = []

    class Counter:
        def kernel(self, name, ins, outs, flops):
            seen.append((name, [tuple(t.shape) for t in outs], flops))
    meta.COUNTERS.append(Counter())
    try:
        q = torch.empty(2, 8, 32, device="meta", dtype=torch.bfloat16)
        k = torch.empty(2, 40, 2, 32, device="meta", dtype=torch.bfloat16)
        s = ops.decode_scores(q, k, 40, 0.1)
        out, lse = ops.decode_values(s, k, 40, return_lse=True)
    finally:
        meta.COUNTERS.pop()
    assert (s.dtype, out.dtype, lse.dtype) == (torch.float32, torch.bfloat16,
                                               torch.float32)
    assert seen == [("decode_scores", [(2, 8, 40)], 2.0 * 2 * 8 * 40 * 32),
                    ("decode_values", [(2, 8, 32), (2, 8)],
                     2.0 * 2 * 8 * 40 * 32)]
