"""Decode over a head_dim-sharded cache on the CPU: the reduced configs
narrowed to one KV head (``n_kv_heads=1``, in both packages), whose cache
``cache_shardings`` shards on head_dim over the model axis, served by gloo
ranks through ``Model.prefill`` and ``Model.serve_step``: each rank's B3-qk
(``ops.decode_scores``) over its slice, the partial scores all-reduced
over the model axis, each rank's B3-pv (``ops.decode_values``) over its V
slice, and no gather of the cache. Two ranks on a (1, 2) mesh (GQA with
MoE, Jamba's attention layer, Gemma-2's softcaps and its ring past the
window, Whisper's self- and cross-attention) and four on a (2, 2) one,
where one row's cache is sharded by sequence over the data axis and on
head_dim over the model axis (B3-pv's log-sum-exp, ``spmd.merge_blocks``);
against the unplaced port and the reference's ``prefill`` /
``serve_step`` on the same weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro_torch.config import InputShape
from repro_torch.configs import get_config as torch_get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from test_kernels import _tol
from test_torch_spmd import _finish, _flatten, _start_ranks
from test_torch_spmd_serve import (QWEN3, SPMD_TOL, STEPS, _WORKER, _inputs,
                                   _reference)

torch.set_num_threads(2)

ONE_KV = {"n_kv_heads": 1}
GEMMA2, JAMBA, WHISPER = "gemma2-2b", "jamba-1.5-large-398b", "whisper-small"
# (arch, mesh, B, prompt S, cache T); Gemma-2's 126 tokens in 256 decode
# past its window ring of 128 (the reference's forward stands in there)
CASES = ([(a, (1, 2), 2, 8, 16) for a in (QWEN3, JAMBA, GEMMA2, WHISPER)]
         + [(GEMMA2, (1, 2), 1, 126, 256)]
         + [(QWEN3, (2, 2), 1, 7, 16), (GEMMA2, (2, 2), 1, 126, 256)])


def _case_id(case):
    arch, mesh, B, S, T = case
    return f"{arch}-{mesh[0]}x{mesh[1]}-B{B}-S{S}"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The (1, 2) cases on two gloo ranks and the (2, 2) ones on four,
    started together, while this process runs the reference on the same
    weights and inputs. -> ([the ranks' records per case], the reference's
    logits per case)."""
    tmp = tmp_path_factory.mktemp("hdsplit")
    inputs = [_inputs(torch_get_config(a).reduced(), B, S, seed=i)
              for i, (a, _, B, S, _) in enumerate(CASES)]
    npz = {}
    for arch in {c[0] for c in CASES}:
        params = JaxModel(dataclasses.replace(get_config(arch).reduced(),
                                              **ONE_KV)).init(
            jax.random.PRNGKey(0))
        npz[arch] = str(tmp / f"{arch}.npz")
        np.savez(npz[arch], **dict(_flatten(jax.tree.map(np.asarray,
                                                         params))))
    runs = {}
    for ranks in (2, 4):
        cases = []
        for i, ((a, m, _, _, T), inp) in enumerate(zip(CASES, inputs)):
            if m[0] * m[1] != ranks:
                continue
            np.savez(tmp / f"inputs{i}.npz", **inp)
            cases.append((i, {"arch": a, "mesh": list(m), "T": T,
                              "npz": npz[a], "repl": ONE_KV,
                              "inputs": str(tmp / f"inputs{i}.npz")}))
        sub = tmp / f"r{ranks}"
        sub.mkdir()
        runs[ranks] = ([i for i, _ in cases], _start_ranks(
            "serve", {"cases": [c for _, c in cases], "collectives": []},
            sub, worker=_WORKER, ranks=ranks))
    want = [None] * len(CASES)
    for arch in {c[0] for c in CASES}:
        idx = [i for i, c in enumerate(CASES) if c[0] == arch]
        _, logits = _reference(arch, [CASES[i][2:5] + (inputs[i],)
                                      for i in idx], repl=ONE_KV)
        for i, lg in zip(idx, logits):
            want[i] = lg
    got = [None] * len(CASES)
    for idx, (procs, out) in runs.values():
        recs = _finish(procs, out)
        for j, i in enumerate(idx):
            got[i] = [r["cases"][j] for r in recs]
    return got, want


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_head_dim_sharded_decode_matches_unplaced(served, i):
    """The cache is sharded on head_dim (and, on the (2, 2) mesh, by
    sequence; Jamba's layer 0 is a Mamba layer); prefill and 3 decode steps give the unplaced port's logits
    and cache within 1e-5 of each tensor's largest element, the same
    logits on every rank; every placed decode attention ran as B3-qk and
    B3-pv, never as whole-head B3."""
    got, _ = served
    arch, mesh, B, S, T = CASES[i]
    for rec in got[i]:
        kv = rec["placements"].get("k")           # layer 0's cache
        assert kv in (None, ["S(1)", "S(3)"] if mesh[0] > 1
                      else ["R", "S(3)"]), kv
        assert max(rec["logit_err"]) <= SPMD_TOL, rec["logit_err"]
        bad = {k: e for k, e in rec["cache_err"].items() if e > SPMD_TOL}
        assert not bad, bad
        assert rec["counts_equal"] and rec["pos_equal"]
        calls = rec["calls"]
        assert calls.get("decode_attention", 0) == 0, calls
        assert calls["decode_scores"] == calls["decode_values"] > 0, calls
        if mesh[0] > 1:
            blocks = [w for layer in rec["seq_blocks_written"]
                      for w in layer]
            assert blocks and all(blocks), rec["seq_blocks_written"]
    assert all(r["logits"] == got[i][0]["logits"] for r in got[i])


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_head_dim_sharded_decode_matches_reference(served, i):
    """The placed run's logits at prefill and every decode step against
    the reference's ``prefill`` / ``serve_step`` of the same one-KV-head
    config on the same weights (past a ring's wrap, its ``forward``),
    within ``test_kernels._tol`` for fp32."""
    got, want = served
    for g, w in zip(got[i][0]["logits"], want[i]):
        np.testing.assert_allclose(np.asarray(g, np.float32), w,
                                   **_tol(jnp.float32))


@pytest.mark.parametrize("arch", [QWEN3, WHISPER])
def test_no_decode_step_gathers_the_cache(arch):
    """The dry run's placed decode step over a head_dim-sharded cache
    (one KV head, a (1, 2) mesh): doubling the cache's length doubles
    nothing gathered (the all-gather bytes are the same) and grows only
    the all-reduced partial scores, by B·H·T fp32 a self-attention layer
    (Whisper's cross-attention reads the encoder's fixed length)."""
    cfg = dataclasses.replace(torch_get_config(arch).reduced(), **ONE_KV)
    mesh = Mesh(("data", "model"), (1, 2))
    B, T = 4, 64
    recs = [dryrun.placed_collectives(
        cfg, InputShape("d", t, B, "decode"), mesh) for t in (T, 2 * T)]
    assert recs[0]["all-gather"] == recs[1]["all-gather"]
    grown = recs[1]["all-reduce"]["bytes"] - recs[0]["all-reduce"]["bytes"]
    assert recs[0]["all-reduce"]["count"] == recs[1]["all-reduce"]["count"]
    assert grown == cfg.n_layers * B * cfg.n_heads * T * 4
