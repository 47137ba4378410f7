"""Global MoE dispatch (the default, ``moe_dispatch="global"``) on a placed
model, on the CPU: two gloo ranks in separate processes run ``Model.loss``
and its backward, ``Model.prefill`` and ``Model.serve_step`` with the
parameters placed over a (1, 2) and a (2, 1) ("data", "model") mesh,
against the unplaced port and against the reference on the same weights.
Every rank sorts all tokens; each model rank runs B1 over its own experts'
blocks, (E/m, C, d), and combines a partial sum reduced over the model
axis."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro_torch.configs import get_config as torch_get_config
from repro_torch.launch import dryrun, report
from repro_torch.models import Model
from repro_torch.models.moe import capacity
from repro_torch.params import reference_leaves
from test_kernels import _tol
from test_torch_spmd import REPO, RANKS, _finish, _flatten, _start_ranks

torch.set_num_threads(2)

QWEN3, DEEPSEEK = "qwen3-moe-235b-a22b", "deepseek-v2-236b"
# (arch, mesh): reduced qwen3-moe (every layer MoE) and DeepSeek-V2 (MLA,
# shared experts, a dense first layer) with the experts over the model axis
# and with the rows over the data axis
CASES = [(a, m) for a in (QWEN3, DEEPSEEK) for m in ((1, RANKS), (RANKS, 1))]
B, S, STEPS = 2, 16, 3
# the direct moe_ffn call: 16 tokens, the last 3 pads, at a capacity
# factor that drops (C 5 over all 16 tokens, 4 at the 13 real ones)
PAD_S, PAD_REAL, PAD_CF = 8, 5, 0.5
# the placed run against the unplaced port: sums split over ranks
# reassociate in fp32 (test_torch_spmd.SPMD_TOL's rule)
SPMD_TOL = 1e-5

_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import sharding, spmd
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model, moe
from repro_torch.params import from_reference

a = json.loads(sys.argv[2])
spmd.start("cpu")
rank = dist.get_rank()


def unflatten(flat):
    tree = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}
    return lists(tree)


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-6)


# every grouped FFN call's input shape (B1's on the card)
shapes = []
_ffn = ops.moe_expert_ffn


def recording(xg, *args, **kw):
    shapes.append(list(xg.shape))
    return _ffn(xg, *args, **kw)


ops.moe_expert_ffn = recording
out = {"cases": []}
for case in a["cases"]:
    cfg = get_config(case["arch"]).reduced()
    with np.load(case["npz"]) as f:
        tree = unflatten({k: f[k] for k in f.files})
    for k in ("prefix", "blocks"):
        tree.setdefault(k, [])
    mesh = Mesh(("data", "model"), tuple(case["mesh"]))
    dm = spmd.device_mesh(mesh, "cpu")
    with np.load(case["inputs"]) as f:
        inp = {k: torch.from_numpy(f[k]) for k in f.files}
    rec = {}

    def loss_and_grads(model):
        model.trainable()
        batch = {"tokens": inp["tokens"]}
        if spmd.is_placed(model.embed):
            batch = sharding.place_batch(batch, dm)
        with spmd.step_context(model):
            loss = model.loss(batch, remat=True)
            loss.backward()
        grads = {n: full(p.grad) for n, p in model.named_parameters()}
        model.trainable(False)
        return float(spmd.local(loss.detach())), grads

    plain = from_reference(Model(cfg, device="cpu"), tree)
    l0, g0 = loss_and_grads(plain)
    placed = sharding.place(from_reference(Model(cfg, device="cpu"), tree),
                            dm, mesh)
    shapes.clear()
    l1, g1 = loss_and_grads(placed)
    rec["loss"] = [l0, l1]
    rec["b1_train"] = list(shapes)
    rec["grad_err"] = {n: rel(g1[n], g0[n]) for n in g0}
    if rank == 0:
        np.savez(case["out_grads"], **{n: g.detach().numpy()
                                       for n, g in g1.items()})
    # prefill (the last row right-padded by 3), then a decode step at each
    # of the given tokens
    B, S = inp["tokens"].shape
    T = S + len(inp["steps"])
    c0 = plain.init_cache(B, T)
    c1 = sharding.place_cache(placed.init_cache(B, T), dm, mesh, cfg,
                              shard_seq=False)
    n = inp["true_len"]
    with torch.no_grad():
        l0, c0, x0 = plain.prefill({"tokens": inp["tokens"]}, c0, true_len=n)
        shapes.clear()
        with spmd.step_context(placed):
            l1, c1, x1 = placed.prefill({"tokens": inp["tokens"]}, c1,
                                        true_len=n)
        rec["b1_prefill"] = list(shapes)
        steps, rec["b1_decode"] = [(l0, l1, x0, x1)], []
        for tok in inp["steps"]:
            l0, c0, x0 = plain.serve_step(c0, tok)
            shapes.clear()
            with spmd.step_context(placed):
                l1, c1, x1 = placed.serve_step(c1, tok)
            rec["b1_decode"] += shapes
            steps.append((l0, l1, x0, x1))
    errs, logits, counts_equal = [], [], True
    for l0, l1, x0, x1 in steps:
        errs.append(rel(l1, l0))
        logits.append(l1.tolist())
        counts_equal &= bool(torch.equal(x0["counts"], x1["counts"]))
    rec.update(logit_err=errs, logits=logits, counts_equal=counts_equal,
               cache_err={f"{i}.{k}": rel(full(b1[k]), b0[k])
                          for i, (b0, b1) in enumerate(zip(c0["layers"],
                                                           c1["layers"]))
                          for k in b0})
    # moe_ffn on the placed layer with a pad row at a capacity factor
    # that drops; an expert_fn or slot-cache weights on a placed model are
    # refused
    layer = next(b.moe for b in placed.layers if hasattr(b, "moe"))
    ref_layer = next(b.moe for b in plain.layers if hasattr(b, "moe"))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, a["pad_s"], cfg.d_model)).astype(np.float32))
    mask = torch.arange(a["pad_s"])[None, :] < torch.tensor(
        [a["pad_s"], a["pad_real"]])[:, None]
    cf = a["pad_cf"]
    with torch.no_grad(), spmd.step_context(placed):
        y1, aux1 = moe.moe_ffn(layer, cfg, spmd.rows(x, dm),
                               capacity_factor=cf, token_mask=mask)
    with torch.no_grad():
        y0, aux0 = moe.moe_ffn(ref_layer, cfg, x, capacity_factor=cf,
                               token_mask=mask)
        # the same call with the pads counted as real tokens
        y2, _ = moe.moe_ffn(ref_layer, cfg, x, capacity_factor=cf)
    rec["pad_err"] = rel(full(y1), y0)
    rec["pad_counts"] = bool(torch.equal(aux0["counts"],
                                         full(aux1["counts"])))
    rec["pad_real_rows_differ"] = rel(y2[0], y0[0]) > 1e-3
    for key, kw in (("expert_fn", {"expert_fn": lambda g, p: g}),
                    ("slot_weights", {"slot_weights": {}})):
        try:
            moe.moe_ffn(layer, cfg, spmd.rows(x, dm), **kw)
            rec[f"{key}_refused"] = ""
        except NotImplementedError as e:
            rec[f"{key}_refused"] = str(e)
    out["cases"].append(rec)
with open(f"{a['out']}.{rank}.json", "w") as f:
    json.dump(out, f)
spmd.stop()
"""


def _case_id(case):
    arch, mesh = case
    return f"{arch}-{mesh[0]}x{mesh[1]}"


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)),
            "true_len": np.array([S, S - 3], np.int32),
            "steps": rng.integers(0, cfg.vocab, (STEPS, B))}


def _reference(arch, inputs):
    """The reference on its seed-0 weights: the loss and every gradient,
    then the logits of ``prefill`` and each ``serve_step`` of each input.
    -> [(loss, grads, logits)]."""
    jm = JaxModel(get_config(arch).reduced())
    params = jm.init(jax.random.PRNGKey(0))
    vg = jax.jit(lambda p, b: jax.value_and_grad(
        lambda q: jm.loss(q, b, remat=True))(p))
    prefill = jax.jit(lambda p, b, c, n: jm.prefill(p, b, c, true_len=n))
    step = jax.jit(jm.serve_step)
    out = []
    for inp in inputs:
        batch = {"tokens": jnp.asarray(inp["tokens"], jnp.int32)}
        loss, grads = vg(params, batch)
        lg, cache, _ = prefill(params, batch, jm.init_cache(B, S + STEPS),
                               jnp.asarray(inp["true_len"]))
        logits = [np.asarray(lg)]
        for tok in inp["steps"]:
            lg, cache, _ = step(params, cache, jnp.asarray(tok, jnp.int32))
            logits.append(np.asarray(lg))
        out.append((float(loss), jax.tree.map(np.asarray, grads), logits))
    return out


@pytest.fixture(scope="module")
def placed_global(tmp_path_factory):
    """One pair of gloo ranks runs every case of ``CASES`` while this
    process runs the reference on the same weights and inputs. -> (the
    ranks' records, the reference's (loss, grads, logits) per case, the
    placed gradients rank 0 wrote, per case)."""
    tmp = tmp_path_factory.mktemp("global")
    inputs = [_inputs(torch_get_config(a).reduced(), seed=i)
              for i, (a, _) in enumerate(CASES)]
    npz = {}
    for arch in (QWEN3, DEEPSEEK):
        params = JaxModel(get_config(arch).reduced()).init(
            jax.random.PRNGKey(0))
        npz[arch] = str(tmp / f"{arch}.npz")
        np.savez(npz[arch], **dict(_flatten(jax.tree.map(np.asarray,
                                                         params))))
    cases = []
    for i, ((arch, mesh), inp) in enumerate(zip(CASES, inputs)):
        np.savez(tmp / f"inputs{i}.npz", **inp)
        cases.append({"arch": arch, "mesh": list(mesh), "npz": npz[arch],
                      "inputs": str(tmp / f"inputs{i}.npz"),
                      "out_grads": str(tmp / f"grads{i}.npz")})
    procs, out = _start_ranks("global", {
        "cases": cases, "pad_s": PAD_S, "pad_real": PAD_REAL,
        "pad_cf": PAD_CF}, tmp, worker=_WORKER)
    want = [None] * len(CASES)
    for arch in (QWEN3, DEEPSEEK):
        idx = [i for i, c in enumerate(CASES) if c[0] == arch]
        for i, r in zip(idx, _reference(arch, [inputs[i] for i in idx])):
            want[i] = r
    recs = _finish(procs, out)
    grads = []
    for c in cases:
        with np.load(c["out_grads"]) as f:
            grads.append({k: f[k] for k in f.files})
    return recs, want, grads


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_global_loss_and_gradients_match_unplaced(placed_global, i):
    """The placed model's loss equals the unplaced one's and every
    gradient is within 1e-5 of its tensor's largest element, on both
    ranks: the experts' gradients are not doubled over the data axis."""
    recs, _, _ = placed_global
    for rec in (r["cases"][i] for r in recs):
        l0, l1 = rec["loss"]
        assert abs(l1 - l0) <= 1e-6 * abs(l0), (l0, l1)
        bad = {n: e for n, e in rec["grad_err"].items() if e > SPMD_TOL}
        assert not bad, bad


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_global_loss_and_gradients_match_reference(placed_global, i):
    """The placed loss and every gradient against the reference's
    ``jax.value_and_grad(model.loss)`` on the same weights, within
    ``test_kernels._tol`` for fp32."""
    recs, want, grads = placed_global
    loss, jgrads, _ = want[i]
    np.testing.assert_allclose(recs[0]["cases"][i]["loss"][1], loss,
                               **_tol(jnp.float32))
    model = Model(torch_get_config(CASES[i][0]).reduced(), device="meta")
    leaves = reference_leaves(model, jgrads)
    assert set(leaves) == set(grads[i])
    for n, g in grads[i].items():
        np.testing.assert_allclose(g, leaves[n], err_msg=n,
                                   **_tol(jnp.float32))


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_each_model_rank_runs_b1_over_its_own_experts(placed_global, i):
    """Every grouped FFN call of the placed steps takes this rank's (E/m,
    C, d) blocks at the step's global capacity: the training step's
    (forward and the remat recompute, C over all B·S tokens), the
    prefill's (capacity factor 2) and each decode step's (dropless, C =
    B). On (2, 1) the experts are not split: (E, C, d)."""
    recs, _, _ = placed_global
    arch, (_, m) = CASES[i]
    cfg = torch_get_config(arch).reduced()
    E, k, d = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    want = {"b1_train": [E // m, capacity(B * S, cfg.moe), d],
            "b1_prefill": [E // m, capacity(B * S, cfg.moe, 2.0), d],
            "b1_decode": [E // m, capacity(B, cfg.moe, E / k), d]}
    moe_layers = sum(hasattr(b, "moe")
                     for b in Model(cfg, device="meta").layers)
    for rec in (r["cases"][i] for r in recs):
        for key, shape in want.items():
            assert rec[key] and all(s == shape for s in rec[key]), \
                (key, rec[key])
        assert len(rec["b1_decode"]) == STEPS * moe_layers
        assert len(rec["b1_prefill"]) == moe_layers


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_global_serving_matches_unplaced_and_reference(placed_global, i):
    """Prefill (the last row right-padded) and 3 decode steps of the placed
    model: the logits and every cache entry within 1e-5 of the unplaced
    port's largest, the counts equal, the logits the same on both ranks
    and within ``_tol`` of the reference's ``prefill`` / ``serve_step``."""
    recs, want, _ = placed_global
    for rec in (r["cases"][i] for r in recs):
        assert max(rec["logit_err"]) <= SPMD_TOL, rec["logit_err"]
        bad = {k: e for k, e in rec["cache_err"].items() if e > SPMD_TOL}
        assert not bad, bad
        assert rec["counts_equal"]
    got = recs[0]["cases"][i]["logits"]
    assert got == recs[1]["cases"][i]["logits"]
    assert len(got) == len(want[i][2]) == STEPS + 1
    for g, w in zip(got, want[i][2]):
        np.testing.assert_allclose(np.asarray(g, np.float32), w,
                                   **_tol(jnp.float32))


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_pads_drop_at_the_real_capacity_and_placed_runtimes_are_refused(
        placed_global, i):
    """``moe_ffn`` on the placed layer over two rows, the second with 3
    pads, at a capacity factor that drops: y and the counts equal the
    unplaced call's (which drops at the 13 real tokens' capacity, so its
    first row differs from the call that counts the pads as tokens); an
    ``expert_fn`` or slot-cache weights on a placed model raise
    ``NotImplementedError`` naming the global dispatch."""
    recs, _, _ = placed_global
    cfg = torch_get_config(CASES[i][0]).reduced()
    assert capacity(2 * PAD_S, cfg.moe, PAD_CF) \
        > capacity(PAD_S + PAD_REAL, cfg.moe, PAD_CF)
    for rec in (r["cases"][i] for r in recs):
        assert rec["pad_err"] <= SPMD_TOL and rec["pad_counts"], rec
        assert rec["pad_real_rows_differ"]
        assert "global dispatch with an expert_fn" in \
            rec["expert_fn_refused"]
        assert "global dispatch with slot-cache weights" in \
            rec["slot_weights_refused"]


# the dry run's qwen3-moe decode_32k record on the debug-multi mesh (pod 2,
# data 2, model 4), at the default dropless decode capacity (C = 128, the
# batch) and at decode_capacity_factor 1.25 (C = 11)
DECODE_RECORD = "qwen3-moe-235b-a22b__decode_32k__multi.json"
# all-gather bytes a device of that record when the (E, C, d) blocks were
# gathered to every rank
GATHERED_BLOCKS_BYTES = 1.2813e10


@pytest.fixture(scope="module")
def decode_records(tmp_path_factory):
    """The dry run's record (``python -m repro_torch.launch.dryrun``) at
    each decode capacity factor: -> {factor: (record, its directory)}."""
    out = {}
    for cf in ("0", "1.25"):
        d = tmp_path_factory.mktemp(f"dryrun_cf{cf}")
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", QWEN3, "--shape", "decode_32k",
                         "--debug-mesh", "--multi-pod", "--set",
                         f"decode_capacity_factor={cf}", "--out", str(d)])
        assert e.value.code == 0
        out[cf] = (json.loads((d / DECODE_RECORD).read_text()), d)
    return out


def test_dry_run_gathers_no_expert_blocks(decode_records):
    """The placed decode step's all-gathers do not grow with the
    capacity: the same bytes (within 1 %) at C = 128 and C = 11, at least
    10x below what gathering the (E, C, d) blocks to every rank cost."""
    (r0, _), (r1, _) = decode_records["0"], decode_records["1.25"]
    g0, g1 = (r["collectives"]["all-gather"]["bytes"] for r in (r0, r1))
    assert 0 < g0 <= GATHERED_BLOCKS_BYTES / 10
    assert abs(g1 - g0) <= 0.01 * g0, (g0, g1)
    assert r0["collectives"]["all-reduce"]["count"] > 0


def test_report_prints_the_collectives_beside_the_goldens(decode_records,
                                                          capsys):
    """``report --goldens experiments/dryrun_ci``: the qwen3-moe decode_32k
    multi record (the only port record in ``--dir``) gets a row per
    collective kind that either side counts, with the port's count and
    bytes and the golden's ``cost_corrected`` ones; no other golden gets
    a row."""
    rec, d = decode_records["0"]
    gold_dir = REPO / "experiments" / "dryrun_ci"
    gold = json.loads((gold_dir / DECODE_RECORD).read_text())
    capsys.readouterr()
    report.main(["--dir", str(d), "--goldens", str(gold_dir)])
    text = capsys.readouterr().out
    rows = [line for line in text.splitlines()
            if line.startswith("| qwen3-moe-235b-a22b__decode_32k__multi |")]
    counts = gold["cost_corrected"]["collective_counts"]
    nbytes = gold["cost_corrected"]["collective_bytes"]
    kinds = [k for k, v in rec["collectives"].items()
             if v["count"] or counts.get(k)]
    assert [r.split(" | ")[1] for r in rows] == kinds
    for row, kind in zip(rows, kinds):
        p = rec["collectives"][kind]
        assert row == (f"| {DECODE_RECORD[:-5]} | {kind} | {p['count']} | "
                       f"{p['bytes']:.4e} | {int(counts.get(kind, 0))} | "
                       f"{nbytes.get(kind, 0):.4e} |")
    assert "| qwen2-1.5b" not in text.split("goldens")[-1]
