"""The kernels' bounds (``repro_torch.kernels.bounds``) at the shapes the
card's smoke run reads them, pinned to the values it has printed: moving
the arithmetic into one module changes no number of its ``kernels`` line.
Pure arithmetic, no device."""
import pytest
import torch

from repro_torch.kernels import bounds
from repro_torch.launch import roofline

torch.set_num_threads(2)

BF16, FP32 = str(torch.bfloat16), str(torch.float32)


@pytest.mark.parametrize("what, got, want, by", [
    # B1 at qwen3-moe's decode shape with every expert filled
    ("B1 every expert", lambda: bounds.moe_ffn(128, 8, 4096, 1536, 2, BF16),
     1.4473, "bytes"),
    # B3 over a 32768-position cache (lengths 32768, 16384, 8192, 1)
    ("B3 S 32768", lambda: bounds.flash_decode(
        4, 64, 4, 128, 32768 + 16384 + 8192 + 1, 2, BF16), 0.035097, "bytes"),
    # B3's halves over one of 2 head_dim slices (hd_l 64) of that cache:
    # B3-qk (q, K and the valid fp32 scores) and B3-pv (the scores, V and
    # the output); B3-qk over one of 16 slices (hd_l 8)
    ("B3-qk S 32768 / 2", lambda: bounds.decode_scores(
        4, 64, 4, 64, 32768 + 16384 + 8192 + 1, 2, BF16), 0.013156, "bytes"),
    ("B3-pv S 32768 / 2", lambda: bounds.decode_values(
        4, 64, 4, 64, 32768 + 16384 + 8192 + 1, 2, BF16), 0.013156, "bytes"),
    ("B3-qk S 32768 / 16", lambda: bounds.decode_scores(
        4, 64, 4, 8, 32768 + 16384 + 8192 + 1, 2, BF16), 0.005479, "bytes"),
    # B3-qk's own bytes, the zeros past each length written too: 62,947,840
    # B at one of 2 slices, 37,228,608 B at one of 16
    ("B3-qk own S 32768 / 2", lambda: bounds.decode_scores_own(
        4, 64, 4, 64, 32768, 32768 + 16384 + 8192 + 1, 2, BF16), 0.018790,
     "bytes"),
    ("B3-qk own S 32768 / 16", lambda: bounds.decode_scores_own(
        4, 64, 4, 8, 32768, 32768 + 16384 + 8192 + 1, 2, BF16), 0.011113,
     "bytes"),
    # B4 at RWKV6's decode shape: 4 rows x 64 heads, r/k/v bf16, w fp32
    ("B4 decode", lambda: bounds.wkv6(256, 1, 64, 2, 4), 0.002582, "bytes"),
    # B5 at Jamba's decode shape: a pool of 4, d_in 16384, N 16, bf16
    ("B5 decode", lambda: bounds.selective_scan(4, 1, 16384, 16, 2),
     0.003013, "bytes"),
    # B4 prefilling one 512-token prompt (64 heads), B5 at B = 1
    ("B4 T 512", lambda: bounds.wkv6(64, 512, 64, 2, 4), 0.010173,
     "operations"),
    ("B5 B 1 T 36", lambda: bounds.selective_scan(1, 36, 16384, 16, 2),
     0.0027, "bytes"),
    ("B5 B 1 T 2048", lambda: bounds.selective_scan(1, 2048, 16384, 16, 2),
     0.101141, "bytes"),
    # the backward kernels at the training shapes (T 128), least work
    ("B4-bwd", lambda: bounds.wkv6_backward(
        256, 128, 64, 2, 4, 256 * 16 * 64 * 64)[:2], 0.022036, "operations"),
    ("B5-bwd", lambda: bounds.selective_scan_backward(
        4, 128, 16384, 16, 2, 4 * 16 * 16384 * 16, 0)[:2], 0.044467,
     "bytes"),
])
def test_bounds_pin_the_printed_values(what, got, want, by):
    ms, by_got = got()
    digits = len(str(want).split(".")[1])
    assert round(ms, digits) == want, what
    assert by_got == by, what


def test_bound_takes_the_larger_term():
    # 3.35e9 B is 1 ms of HBM; 989e9 bf16 / 67e9 fp32 products are 1 ms
    assert bounds.bound(3.35e9, 0, BF16) == pytest.approx((1.0, "bytes"))
    assert bounds.bound(0, 989e9, BF16) == pytest.approx((1.0, "operations"))
    assert bounds.bound(0, 67e9, torch.float32)[0] == pytest.approx(1.0)
    assert bounds.bound(3.35e9, 2 * 67e9, FP32) == \
        pytest.approx((2.0, "operations"))


def test_routed_counts_set_the_expert_ffn_bounds():
    """Only the experts with a routed row are read and only the routed
    rows multiplied; unrouted work costs nothing."""
    E, C, d, f = 128, 8, 4096, 1536
    full = bounds.moe_ffn(E, C, d, f, 2, BF16)[0]
    half = bounds.moe_ffn(E, C, d, f, 2, BF16, rows=16, experts=16)[0]
    assert half == pytest.approx(2 * (2 * E * C * d + 16 * 3 * d * f)
                                 / bounds.HBM_BYTES_PER_S * 1e3)
    assert half < full
    # B2: int8 slots with scales, and the bytes term alone at rows=0
    ms, by = bounds.moe_ffn_quant(E, C, d, f, x_esz=2, w_esz=1, out_esz=2,
                                  rows=0, slots_read=16)
    per_slot = 3 * d * f + 4 * (2 * f + d)
    assert by == "bytes"
    assert ms == pytest.approx((2 * E * C * d * 2 + 16 * per_slot + 4 * E)
                               / bounds.HBM_BYTES_PER_S * 1e3)
    fp16 = bounds.moe_ffn_quant(E, C, d, f, x_esz=2, w_esz=2, out_esz=2,
                                rows=32, slots_read=16, scales=False)[0]
    assert fp16 == pytest.approx(bounds.moe_ffn(E, C, d, f, 2, BF16,
                                                rows=32, experts=16)[0])


def test_backward_bounds_add_this_designs_own_work():
    E, C, d, f = 128, 41, 4096, 1536
    ms, by, design = bounds.moe_ffn_backward(E, C, d, f, 2, BF16,
                                             rows=E * C, experts=E)
    assert by == "bytes" and design > ms
    assert design - ms == pytest.approx(2 * E * 2 * d * f
                                        / bounds.HBM_BYTES_PER_S * 1e3)
    BH, T, hd = 256, 128, 64
    ck = BH * (T // 8) * hd * hd
    ms4, _, d4, _ = bounds.wkv6_backward(BH, T, hd, 2, 4, ck)
    assert d4 > ms4
    B, T, D, N = 4, 128, 16384, 16
    ms5, _, d5, _ = bounds.selective_scan_backward(B, T, D, N, 2, 0, 0)
    ms5b, _, d5b, _ = bounds.selective_scan_backward(B, T, D, N, 2,
                                                     B * D * N * 16, 10**6)
    assert ms5 == ms5b and d5b > d5 >= ms5


def test_forward_bounds_grow_with_the_valid_work():
    assert bounds.flash_decode(4, 64, 4, 128, 100, 2, BF16)[0] < \
        bounds.flash_decode(4, 64, 4, 128, 200, 2, BF16)[0]
    for half in (bounds.decode_scores, bounds.decode_values):
        assert half(4, 64, 4, 64, 100, 2, BF16)[0] < \
            half(4, 64, 4, 64, 200, 2, BF16)[0]
    # the zeros past the lengths: B3-qk's own bytes exceed the function's
    # by the invalid scores, and not at all when every row is full
    own = bounds.decode_scores_own(4, 64, 4, 64, 300, 1000, 2, BF16)[0]
    assert own - bounds.decode_scores(4, 64, 4, 64, 1000, 2, BF16)[0] == \
        pytest.approx(4 * 64 * (4 * 300 - 1000) / bounds.HBM_BYTES_PER_S
                      * 1e3)
    assert bounds.decode_scores_own(4, 64, 4, 64, 300, 1200, 2, BF16)[0] \
        == pytest.approx(bounds.decode_scores(4, 64, 4, 64, 1200, 2, BF16)[0])
    assert bounds.wkv6(256, 2, 64, 2, 4)[0] > bounds.wkv6(256, 1, 64, 2, 4)[0]
    assert bounds.selective_scan(1, 2048, 16384, 16, 2)[0] > \
        bounds.selective_scan(1, 36, 16384, 16, 2)[0]


def test_the_roofline_reads_the_same_peaks():
    assert roofline.PEAK_FLOPS == bounds.PEAK_FLOPS[BF16]
    assert roofline.HBM_BW == bounds.HBM_BYTES_PER_S
