"""The port's expert wire and slot-cache mechanics against the reference:
the plain dequantizing slot-indexed expert FFN (``moe_ffn_quant_ref``)
against the Pallas ``moe_ffn_slots`` in interpret mode, the host store's
wire images against ``repro.core.slot_cache.HostExpertStore`` bit for bit,
the staging discipline of ``ExpertSlotCache``, and the launcher's report
at ``--resident-fraction 0.5`` over each ``--transfer-dtype``.

The CUDA kernel (B2) itself is held against the plain version on the card
by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import contextlib
import copy
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import quant
from repro.core.slot_cache import HostExpertStore as JaxHostExpertStore
from repro.kernels.moe_ffn import moe_ffn_quant as pallas_moe_ffn_quant
from repro.kernels.moe_ffn import moe_ffn_slots
from repro.launch import serve as jax_serve
from repro.models import Model as JaxModel
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.slot_cache import (ExpertSlotCache, HostExpertStore,
                                         quantize_weight)
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as torch_serve
from repro_torch.models import Model
from repro_torch.params import from_reference

torch.set_num_threads(2)

ARCH = "qwen3-moe-235b-a22b"
N_MOE, N_EXPERTS = 2, 4          # reduced qwen3-moe: 2 MoE layers x 4 experts

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str):
    # tests/test_kernels.py's limits: fp32 sums in another order; bf16
    # rounds the output (and, in the Pallas kernel, each f-block's sum)
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(get_config(ARCH).reduced())
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model(torch_get_config(ARCH).reduced(), device="cpu")
    from_reference(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


# ---------------------------------------------------------------------------
# B2's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

def _slot_inputs(wire, act, seed=0):
    """fp32 expert weights quantized per expert with the reference's
    ``quant.quantize_weight`` and laid out as 5 slot buffers, plus a slot
    table in which expert 3 is not resident (clamped to slot 0)."""
    rng = np.random.default_rng(seed)
    E, C, d, f, n = 4, 64, 128, 256, 5
    xg = rng.standard_normal((E, C, d), np.float32)
    slot_ids = np.array([2, 4, 1, 0], np.int32)
    bufs = {}
    names = ("w_gate", "w_up", "w_down") if act == "swiglu" \
        else ("w_up", "w_down")
    for name in names:
        shape = (f, d) if name == "w_down" else (d, f)
        ws = [quant.quantize_weight(
            rng.standard_normal(shape, np.float32) * 0.05, wire)
            for _ in range(n)]
        bufs[name] = np.stack([w for w, _ in ws])
        if ws[0][1] is not None:
            bufs[name + "_scale"] = np.stack([s for _, s in ws])
    return xg, bufs, slot_ids


@pytest.mark.parametrize("wire", ["fp32", "fp16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_ffn_quant_plain_matches_pallas_slots(wire, dtype, act):
    xg, bufs, slot_ids = _slot_inputs(wire, act)
    jd, td = DTYPES[dtype]
    want = moe_ffn_slots(jnp.asarray(xg).astype(jd),
                         {k: jnp.asarray(v) for k, v in bufs.items()},
                         jnp.asarray(slot_ids), act=act, block_c=64,
                         block_f=128, interpret=True)
    tbufs = {k: torch.from_numpy(v) for k, v in bufs.items()}
    txg = torch.from_numpy(xg).to(td)
    got = ops.moe_expert_ffn_slots(txg, tbufs, torch.from_numpy(slot_ids),
                                   act=act)
    assert got.dtype == td and got.shape == xg.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))
    # out_dtype only changes the final rounding: the fp32 result rounds to
    # the default one
    y32 = ops.moe_expert_ffn_slots(txg, tbufs, torch.from_numpy(slot_ids),
                                   act=act, out_dtype=torch.float32)
    assert y32.dtype == torch.float32
    assert torch.equal(y32.to(td), got)


def test_moe_ffn_quant_plain_master_wire_is_moe_ffn_ref():
    """No scales and weights in x's dtype: the plain version is
    ``moe_ffn_ref`` on the gathered weights, bit for bit (B1's
    delegation)."""
    xg, bufs, slot_ids = _slot_inputs("fp32", "swiglu", seed=2)
    t = {k: torch.from_numpy(v) for k, v in bufs.items()}
    idx = torch.from_numpy(slot_ids).long()
    y = ref.moe_ffn_quant_ref(torch.from_numpy(xg), t["w_gate"], t["w_up"],
                              t["w_down"], None, None, None,
                              torch.from_numpy(slot_ids))
    assert torch.equal(y, ref.moe_ffn_ref(
        torch.from_numpy(xg), t["w_gate"][idx], t["w_up"][idx],
        t["w_down"][idx]))


# rows of each expert that carry a token (the rest of xg is exactly zero):
# a full expert, an empty one, one row, a scattered pair, empty again
ROUTED = [list(range(16)), [], [3], [0, 15], []]


@pytest.mark.parametrize("wire", ["fp16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_moe_ffn_quant_zero_rows_give_zero_rows(wire, dtype, act):
    """The invariant B2's kernel skips on: over dequantized wire weights,
    every activation maps a zero row of xg to a +0.0 row of y, so a zero
    row (and an expert with only zero rows) needs no weight and no scale.
    Held by the port's plain version and the Pallas ``moe_ffn_quant`` in
    interpret mode on the same numpy-seeded inputs and slot table."""
    E, C, d, f, n = len(ROUTED), 16, 128, 256, 7
    rng = np.random.default_rng(23)
    mask = np.zeros((E, C, 1), np.float32)
    for e, rows in enumerate(ROUTED):
        mask[e, rows] = 1.0
    xg = rng.standard_normal((E, C, d), np.float32) * mask
    slot_ids = np.array([6, 0, 3, 1, 5], np.int32)
    bufs = {}
    names = ("w_gate", "w_up", "w_down") if act in ("swiglu", "geglu") \
        else ("w_up", "w_down")
    for name in names:
        shape = (f, d) if name == "w_down" else (d, f)
        ws = [quant.quantize_weight(
            rng.standard_normal(shape, np.float32) * 0.05, wire)
            for _ in range(n)]
        bufs[name] = np.stack([w for w, _ in ws])
        if ws[0][1] is not None:
            bufs[name + "_scale"] = np.stack([s for _, s in ws])
    jd, td = DTYPES[dtype]

    def taken(name):        # the gathered (E, ...) operand, or None
        return (jnp.asarray(bufs[name][slot_ids]) if name in bufs
                else None)
    pallas = pallas_moe_ffn_quant(
        jnp.asarray(xg).astype(jd), taken("w_gate"), taken("w_up"),
        taken("w_down"), taken("w_gate_scale"), taken("w_up_scale"),
        taken("w_down_scale"), act=act, block_c=16, block_f=128,
        interpret=True)
    t = {k: torch.from_numpy(v) for k, v in bufs.items()}
    port = ref.moe_ffn_quant_ref(
        torch.from_numpy(xg).to(td), t.get("w_gate"), t["w_up"],
        t["w_down"], t.get("w_gate_scale"), t.get("w_up_scale"),
        t.get("w_down_scale"), torch.from_numpy(slot_ids), act=act,
        out_dtype=torch.float32)
    zero = mask[..., 0] == 0
    assert not np.signbit(port.numpy()[zero]).any()
    for name, y in (("port", port.numpy()),
                    ("pallas", np.asarray(pallas, np.float32))):
        assert (y[zero] == 0).all(), name
        assert (y[~zero] != 0).any(axis=-1).all(), name
    np.testing.assert_allclose(port.to(td).float().numpy(),
                               np.asarray(pallas, np.float32), **_tol(dtype))


# ---------------------------------------------------------------------------
# The host store's wire images against the reference's
# ---------------------------------------------------------------------------

def test_quantizer_bit_equal_on_edge_cases():
    """Round-half-even ties, an all-zero output channel, a channel whose
    extreme is negative, and subnormal fp16 values."""
    w = np.array([[0.5, 0.0, -127.0, 1e-6],
                  [1.5, 0.0, 63.5, -3e-7],
                  [-2.5, 0.0, 12.7, 6e-8],
                  [127.0, 0.0, -0.35, 2e-5]], np.float32)
    for wire in ("fp16", "int8"):
        want_q, want_s = quant.quantize_weight(w, wire)
        got_q, got_s = quantize_weight(torch.from_numpy(w), wire)
        assert got_q.numpy().dtype == want_q.dtype
        assert np.array_equal(got_q.numpy(), want_q)
        if want_s is None:
            assert got_s is None
        else:
            assert np.array_equal(got_s.numpy(), want_s)


@pytest.mark.parametrize("wire", ["fp32", "fp16", "int8"])
def test_host_store_matches_reference_bit_for_bit(models, wire):
    jm, params, tm = models
    want = JaxHostExpertStore(jm, params, transfer_dtype=wire)
    got = HostExpertStore(copy.deepcopy(tm), transfer_dtype=wire)
    assert got.names == want.names
    assert got.wire_names == want.wire_names
    assert got.slot_shapes == {k: tuple(v)
                               for k, v in want.slot_shapes.items()}
    assert got.wire_shapes == {k: tuple(v)
                               for k, v in want.wire_shapes.items()}
    assert got.expert_bytes == want.expert_bytes
    assert got.wire_expert_bytes == want.wire_expert_bytes
    for li in range(N_MOE):
        for e in range(N_EXPERTS):
            w, g = want.wire_expert(li, e), got.wire_expert(li, e)
            assert set(g) == set(w)
            for k in w:
                assert g[k].numpy().dtype == w[k].dtype, k
                assert np.array_equal(g[k].numpy(), w[k]), (li, e, k)
            assert quant.wire_nbytes(
                {k: v.numpy() for k, v in g.items()}) == \
                got.wire_expert_bytes
            # the master view is the reference's fp32 expert
            for k, v in want.expert(li, e).items():
                assert np.array_equal(got.expert(li, e)[k].numpy(), v)


# ---------------------------------------------------------------------------
# Staging discipline
# ---------------------------------------------------------------------------

def test_staged_rows_invisible_until_commit(models):
    """An upload that replaces a slot is staged: the slot buffers keep the
    old expert until ``commit``, which lands the new one."""
    store = HostExpertStore(copy.deepcopy(models[2]))
    cache = ExpertSlotCache(store, n_slots=2)
    cache.prefetch([(0, 0), (0, 1)])
    bufs0 = {k: v.clone() for k, v in cache.commit().items()}
    s0 = int(cache.slot_of[0, 0])
    assert torch.equal(bufs0["w_up"][s0], store.expert(0, 0)["w_up"])
    cache.evict((0, 0))
    cache.prefetch([(0, 2)])
    assert (0, 2) in cache                    # staged counts as resident
    assert int(cache.slot_of[0, 2]) == s0     # reuses the freed slot
    assert torch.equal(cache.bufs["w_up"][s0], store.expert(0, 0)["w_up"])
    cache.commit()
    assert torch.equal(cache.bufs["w_up"][s0], store.expert(0, 2)["w_up"])
    s1 = int(cache.slot_of[0, 1])
    assert torch.equal(cache.bufs["w_up"][s1], bufs0["w_up"][s1])


def test_evicted_staged_upload_is_dropped(models):
    store = HostExpertStore(copy.deepcopy(models[2]), transfer_dtype="int8")
    cache = ExpertSlotCache(store, n_slots=1)
    cache.prefetch([(0, 0)])
    cache.evict((0, 0))                       # staged, never committed
    assert not cache._staged
    cache.commit()
    assert all(torch.all(b == 0) for b in cache.bufs.values())
    assert cache.stats()["upload_bytes"] == store.wire_expert_bytes


# ---------------------------------------------------------------------------
# The launcher at rf 0.5 over each wire
# ---------------------------------------------------------------------------

def _report(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    keep = ("req ", "total:", "tiers:", "slots:", "eamc:", "predictor:")
    out = []
    for line in buf.getvalue().splitlines():
        if line.startswith(keep):
            line = re.sub(r", compiles=.*$", "", line)
            out.append(re.sub(r"demand-stall=\S+ \(\S+\) ", "", line))
    return out


@pytest.mark.parametrize("wire", ["fp32", "fp16", "int8"])
def test_launcher_streaming_report_matches_reference(models, wire):
    _, params, _ = models
    flags = ["--arch", ARCH, "--reduced", "--requests", "3", "--seed", "3",
             "--resident-fraction", "0.5", "--transfer-dtype", wire]
    want = _report(lambda: jax_serve.main(flags))
    cfg = torch_get_config(ARCH).reduced()
    model = from_reference(Model(cfg, device="cpu"),
                           jax.tree.map(np.asarray, params))
    args = torch_serve.parse_args(flags + ["--device", "cpu"])
    got = _report(lambda: torch_serve.serve(args, cfg, model))
    assert len(want) == 3 + 5
    assert [ln for ln in want if ln.startswith("slots:")][0].startswith(
        f"slots: resident={N_MOE * N_EXPERTS // 2}/{N_MOE * N_EXPERTS} ")
    assert got == want
