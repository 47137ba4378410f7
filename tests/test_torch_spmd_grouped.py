"""Grouped MoE dispatch (``moe_dispatch="grouped"``) on a placed model,
on the CPU: two gloo ranks in separate processes run ``Model.loss`` and its
backward, ``Model.prefill`` and ``Model.serve_step`` with the parameters
placed over a (1, 2) and a (2, 1) ("data", "model") mesh, against the
unplaced port and against the reference's grouped dispatch on the same
weights. Each rank dispatches its own rows and runs B1 over its own
experts' blocks, (E/m, (B/dp)·C, d)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import Model
from repro_torch.params import reference_leaves
from test_kernels import _tol
from test_torch_spmd import RANKS, _finish, _flatten, _start_ranks

torch.set_num_threads(2)

QWEN3, DEEPSEEK = "qwen3-moe-235b-a22b", "deepseek-v2-236b"
GROUPED = dict(moe_dispatch="grouped")
# (arch, mesh): reduced qwen3-moe (every layer MoE) and DeepSeek-V2 (MLA,
# shared experts, a dense first layer) with the experts over the model axis
# and with the rows over the data axis
CASES = [(a, m) for a in (QWEN3, DEEPSEEK) for m in ((1, RANKS), (RANKS, 1))]
B, S, STEPS = 2, 16, 3
# the placed run against the unplaced port: sums split over ranks
# reassociate in fp32 (test_torch_spmd.SPMD_TOL's rule)
SPMD_TOL = 1e-5

_WORKER = r"""
import dataclasses, json, sys
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
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              moe_dispatch="grouped")
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
    rec["b1_shapes"] = list(shapes)
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
    logits, errs, tokens_equal = [], [], True
    with torch.no_grad():
        l0, c0, x0 = plain.prefill({"tokens": inp["tokens"]}, c0, true_len=n)
        with spmd.step_context(placed):
            l1, c1, x1 = placed.prefill({"tokens": inp["tokens"]}, c1,
                                        true_len=n)
        steps = [(l0, l1, x0, x1)]
        for tok in inp["steps"]:
            l0, c0, x0 = plain.serve_step(c0, tok)
            with spmd.step_context(placed):
                l1, c1, x1 = placed.serve_step(c1, tok)
            steps.append((l0, l1, x0, x1))
    for l0, l1, x0, x1 in steps:
        errs.append(rel(l1, l0))
        logits.append(l1.tolist())
        tokens_equal &= bool(torch.equal(l0.argmax(-1), l1.argmax(-1)))
        tokens_equal &= bool(torch.equal(x0["counts"], x1["counts"]))
    rec.update(logit_err=errs, logits=logits, tokens_equal=tokens_equal)
    # one row of x over a mesh whose data axis it does not split: the
    # groups replicate; an expert_fn on a placed model is refused
    layer = next(b.moe for b in placed.layers if hasattr(b, "moe"))
    ref_layer = next(b.moe for b in plain.layers if hasattr(b, "moe"))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 8, cfg.d_model)).astype(np.float32))
    shapes.clear()
    with torch.no_grad(), spmd.step_context(placed):
        y1, aux1 = moe.moe_ffn_grouped(layer, cfg, spmd.rows(x, dm))
    rec["one_row_shapes"] = list(shapes)
    y0, aux0 = moe.moe_ffn_grouped(ref_layer, cfg, x)
    rec["one_row_err"] = rel(full(y1), y0)
    rec["one_row_counts"] = bool(torch.equal(aux0["counts"],
                                             full(aux1["counts"])))
    try:
        moe.moe_ffn_grouped(layer, cfg, spmd.rows(x, dm),
                            expert_fn=lambda g, p: g)
        rec["expert_fn_refused"] = False
    except NotImplementedError:
        rec["expert_fn_refused"] = True
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
    """The reference's grouped dispatch on its seed-0 weights: the loss
    and every gradient, then the logits of ``prefill`` and each
    ``serve_step`` of each input. -> (params, [(loss, grads, logits)])."""
    jm = JaxModel(dataclasses.replace(get_config(arch).reduced(), **GROUPED))
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
    return params, out


@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    """One pair of gloo ranks runs every case of ``CASES`` while this
    process runs the reference on the same weights and inputs. -> (the
    ranks' records, the reference's (loss, grads, logits) per case, the
    placed gradients rank 0 wrote, per case)."""
    tmp = tmp_path_factory.mktemp("grouped")
    inputs = [_inputs(torch_get_config(a).reduced(), seed=i)
              for i, (a, _) in enumerate(CASES)]
    npz = {}
    for arch in (QWEN3, DEEPSEEK):
        params = JaxModel(dataclasses.replace(
            get_config(arch).reduced(), **GROUPED)).init(
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
    procs, out = _start_ranks("grouped", {"cases": cases}, tmp,
                              worker=_WORKER)
    want = [None] * len(CASES)
    for arch in (QWEN3, DEEPSEEK):
        idx = [i for i, c in enumerate(CASES) if c[0] == arch]
        _, res = _reference(arch, [inputs[i] for i in idx])
        for i, r in zip(idx, res):
            want[i] = r
    recs = _finish(procs, out)
    grads = []
    for c in cases:
        with np.load(c["out_grads"]) as f:
            grads.append({k: f[k] for k in f.files})
    return recs, want, grads


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_grouped_loss_and_gradients_match_unplaced(grouped, i):
    """The placed grouped model's loss equals the unplaced one's and every
    gradient is within 1e-5 of its tensor's largest element, on both
    ranks."""
    recs, _, _ = grouped
    for rec in (r["cases"][i] for r in recs):
        l0, l1 = rec["loss"]
        assert abs(l1 - l0) <= 1e-6 * abs(l0), (l0, l1)
        bad = {n: e for n, e in rec["grad_err"].items() if e > SPMD_TOL}
        assert not bad, bad


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_grouped_loss_and_gradients_match_reference(grouped, i):
    """The placed grouped loss and every gradient against the reference's
    ``jax.value_and_grad(model.loss)`` with ``moe_dispatch="grouped"`` on
    the same weights, within ``test_kernels._tol`` for fp32."""
    recs, want, grads = grouped
    loss, jgrads, _ = want[i]
    np.testing.assert_allclose(recs[0]["cases"][i]["loss"][1], loss,
                               **_tol(jnp.float32))
    arch = CASES[i][0]
    model = Model(dataclasses.replace(torch_get_config(arch).reduced(),
                                      **GROUPED), device="meta")
    leaves = reference_leaves(model, jgrads)
    assert set(leaves) == set(grads[i])
    for n, g in grads[i].items():
        np.testing.assert_allclose(g, leaves[n], err_msg=n,
                                   **_tol(jnp.float32))


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_each_rank_runs_b1_over_its_own_blocks(grouped, i):
    """Every grouped FFN call of the placed step (each MoE layer, forward
    and the remat recompute) takes this rank's (E/m, (B/dp)·C, d) blocks."""
    recs, _, _ = grouped
    arch, (dp, m) = CASES[i]
    cfg = torch_get_config(arch).reduced()
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    C = int(S * k / E * cfg.moe.capacity_factor) + 1
    C = max(k, min(C, S))
    for rec in (r["cases"][i] for r in recs):
        assert rec["b1_shapes"], rec
        assert all(s == [E // m, (B // dp) * C, cfg.d_model]
                   for s in rec["b1_shapes"]), rec["b1_shapes"]


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_grouped_serving_matches_unplaced_and_reference(grouped, i):
    """Prefill (the last row right-padded) and 3 decode steps of the placed
    grouped model: the logits within 1e-5 of the unplaced port's largest,
    the greedy tokens and counts equal, the logits the same on both ranks
    and within ``_tol`` of the reference's ``prefill`` / ``serve_step``."""
    recs, want, _ = grouped
    for rec in (r["cases"][i] for r in recs):
        assert max(rec["logit_err"]) <= SPMD_TOL, rec["logit_err"]
        assert rec["tokens_equal"]
    got = recs[0]["cases"][i]["logits"]
    assert got == recs[1]["cases"][i]["logits"]
    assert len(got) == len(want[i][2]) == STEPS + 1
    for g, w in zip(got, want[i][2]):
        np.testing.assert_allclose(np.asarray(g, np.float32), w,
                                   **_tol(jnp.float32))


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_one_row_replicates_its_group_and_expert_fn_is_refused(grouped, i):
    """``moe_ffn_grouped`` over one row of x on the placed layer: a batch
    the data axis does not split replicates its group (B1 over (E/m, C,
    d)), y and the counts equal the unplaced call's; an ``expert_fn`` on a
    placed model raises ``NotImplementedError``."""
    recs, _, _ = grouped
    arch, (dp, m) = CASES[i]
    cfg = torch_get_config(arch).reduced()
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    C = max(k, min(int(8 * k / E * cfg.moe.capacity_factor) + 1, 8))
    for rec in (r["cases"][i] for r in recs):
        assert rec["one_row_err"] <= SPMD_TOL
        assert rec["one_row_counts"] and rec["expert_fn_refused"]
        assert rec["one_row_shapes"] == [[E // m, C, cfg.d_model]]

