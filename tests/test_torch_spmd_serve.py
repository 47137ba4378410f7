"""The serving steps on a placed model (``Model.prefill`` and
``Model.serve_step`` over a (data, model) mesh, the cache placed by
``sharding.place_cache``) on the CPU: two gloo ranks in separate
processes, against the unplaced port and against the reference's
``prefill`` / ``serve_step`` on the same weights; the dry run's serving
collectives against those the ranks issue; B3's log-sum-exp merge."""
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
from repro_torch.kernels import ref
from repro_torch.launch import dryrun, roofline, spmd
from repro_torch.launch.mesh import Mesh
from test_kernels import _tol
from test_torch_spmd import RANKS, _finish, _flatten, _start_ranks

torch.set_num_threads(2)

QWEN3 = "qwen3-moe-235b-a22b"
ARCHS = [QWEN3, "rwkv6-7b", "jamba-1.5-large-398b", "gemma2-2b",
         "deepseek-v2-236b", "whisper-small"]
STEPS = 3
# (arch, mesh, B, prompt S, cache T): every arch on (1, 2) and (2, 1) at
# B = 2; then B = 1 on (2, 1), where the cache's sequence is sharded
# (shard_seq) into two blocks, rank 1's starting at T / 2:
#  - qwen3-moe, 7 tokens in 16: rank 1's block is empty at the first
#    decode step (position 7) and takes positions 8 and 9, so the last two
#    steps merge two live blocks;
#  - qwen3-moe, DeepSeek-V2 (MLA) and Gemma-2, 10 tokens in 16: the
#    prefill fills both blocks (Gemma-2's local layer a ring of 16);
#  - Gemma-2, 126 tokens in 256: its window ring of 128 (64 a rank) is
#    full on both ranks after the prefill and the decode wraps it onto
#    rank 0's block (positions 126, 127, then 128 at slot 0), while its
#    global cache's rank 1 takes position 128
CASES = ([(a, (1, RANKS), 2, 8, 16) for a in ARCHS]
         + [(a, (RANKS, 1), 2, 8, 16) for a in ARCHS]
         + [(a, (RANKS, 1), 1, S, T) for a, S, T in
            ((QWEN3, 7, 16), (QWEN3, 10, 16), ("deepseek-v2-236b", 10, 16),
             ("gemma2-2b", 10, 16), ("gemma2-2b", 126, 256))])
# the placed run against the unplaced port: sums split over ranks
# reassociate in fp32, so each tensor is held to 1e-5 of its largest
# element (test_torch_spmd.SPMD_TOL's rule)
SPMD_TOL = 1e-5


def _case_id(case):
    arch, mesh, B, S, T = case
    return f"{arch}-{mesh[0]}x{mesh[1]}-B{B}" + (f"-S{S}" if B == 1 else "")


def _inputs(cfg, B, S, seed):
    """numpy tokens (B, S), each row's real length (the last row
    right-padded by 3 when B > 1), one (B,) token a decode step, and
    Whisper's encoder frames (B, encoder_seq_len, d)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
           "true_len": np.array([S] * (B - 1) + [S - 3 if B > 1 else S],
                                np.int32),
           "steps": rng.integers(0, cfg.vocab, (STEPS, B))}
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return out


# what each rank runs; each rank writes <out>.<rank>.json
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
from repro_torch.models import Model
from repro_torch.params import from_reference

a = json.loads(sys.argv[2])
spmd.start("cpu")


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


# each attention kernel's calls (B3, B3-qk, B3-pv on the card) in the
# placed decode steps of a case
calls = {}
for name in ("decode_attention", "decode_scores", "decode_values"):
    def counted(*args, _name=name, _fn=getattr(ops, name), **kw):
        calls[_name] = calls.get(_name, 0) + 1
        return _fn(*args, **kw)
    setattr(ops, name, counted)
out = {"cases": [], "collectives": []}
for case in a["cases"]:
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              **case.get("repl", {}))
    with np.load(case["npz"]) as f:
        tree = unflatten({k: f[k] for k in f.files})
    for k in ("prefix", "blocks"):      # empty stacks leave no file entry
        tree.setdefault(k, [])
    mesh = Mesh(("data", "model"), tuple(case["mesh"]))
    dm = spmd.device_mesh(mesh, "cpu")
    plain = from_reference(Model(cfg, device="cpu"), tree)
    placed = sharding.place(from_reference(Model(cfg, device="cpu"), tree),
                            dm, mesh)
    with np.load(case["inputs"]) as f:
        inp = {k: torch.from_numpy(f[k]) for k in f.files}
    batch = {k: inp[k] for k in ("tokens", "enc_embeds") if k in inp}
    B, T = batch["tokens"].shape[0], case["T"]
    c0 = plain.init_cache(B, T)
    c1 = sharding.place_cache(placed.init_cache(B, T), dm, mesh, cfg,
                              shard_seq=True)
    rec = {"logit_err": [], "logits": [], "cache_err": {}, "counts_equal":
           True, "placements": {k: [str(p) for p in t.placements]
                                for k, t in c1["layers"][0].items()}}
    n = inp["true_len"]
    with torch.no_grad():
        l0, c0, x0 = plain.prefill(batch, c0, true_len=n)
        with spmd.step_context(placed):
            l1, c1, x1 = placed.prefill(batch, c1, true_len=n)
        steps = [(l0, l1, x0, x1)]
        rec["calls"] = {}
        for tok in inp["steps"]:
            l0, c0, x0 = plain.serve_step(c0, tok)
            calls.clear()
            with spmd.step_context(placed):
                l1, c1, x1 = placed.serve_step(c1, tok)
            for k, v in calls.items():
                rec["calls"][k] = rec["calls"].get(k, 0) + v
            steps.append((l0, l1, x0, x1))
    for l0, l1, x0, x1 in steps:
        assert not isinstance(l1, DTensor)
        rec["logit_err"].append(rel(l1, l0))
        rec["logits"].append(l1.tolist())
        if x0["counts"] is not None:
            rec["counts_equal"] &= bool(torch.equal(x0["counts"],
                                                    x1["counts"]))
    for i, (a0, a1) in enumerate(zip(c0["layers"], c1["layers"])):
        for k in a0:
            rec["cache_err"][f"{i}.{k}"] = rel(full(a1[k]), a0[k])
    rec["pos_equal"] = bool(torch.equal(full(c1["pos"]), c0["pos"]))
    # per layer, whether this rank's block of each sequence-sharded entry
    # holds a written position
    rec["seq_blocks_written"] = [
        [bool(t.to_local().abs().sum() > 0) for t in layer.values()
         if any(p.is_shard(1) for p in t.placements)]
        for layer in c1["layers"]]
    out["cases"].append(rec)
for case in a["collectives"]:
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              **case.get("repl", {}))
    mesh = Mesh(("data", "model"), tuple(case["mesh"]))
    dm = spmd.device_mesh(mesh, "cpu")
    model = sharding.place(Model(cfg, device="cpu").init(0), dm, mesh)
    B, T, win = case["B"], case["T"], case["window"]
    cache = sharding.place_cache(model.init_cache(B, T, win), dm, mesh, cfg,
                                 shard_seq=B < mesh.sizes[0])
    counter = spmd.CollectiveCounter()
    with torch.no_grad(), counter, spmd.step_context(model):
        model.serve_step(cache, torch.zeros(B, dtype=torch.int32),
                         decode_window=win)
    out["collectives"].append(counter.record())
with open(f"{a['out']}.{dist.get_rank()}.json", "w") as f:
    json.dump(out, f)
spmd.stop()
"""

# the dry run's decode records against the ranks' counter: a decode_32k
# cell (batch rows over the data axis, heads over the model axis), the
# same cell under grouped dispatch (the experts' blocks over the model
# axis, each data rank's own rows) and with one KV head (the cache sharded
# on head_dim: B3-qk, the scores' all-reduce, B3-pv), and a long_500k one
# (one row, Gemma-2's window rings sharded over the data axis by
# sequence), all cut to reduced sizes; the last entry overrides the config.
# Last, the decode_32k cell with its rows over the data axis: global
# dispatch gathers the rows (every rank sorts all tokens), not the blocks
DECODE_32K = InputShape("decode_32k", 64, 4, "decode")
COLLECTIVE_CASES = [
    (QWEN3, (1, RANKS), DECODE_32K, {}),
    ("gemma2-2b", (RANKS, 1), InputShape("long_500k", 256, 1, "decode"), {}),
    (QWEN3, (1, RANKS), DECODE_32K, {"moe_dispatch": "grouped"}),
    (QWEN3, (RANKS, 1), DECODE_32K, {"moe_dispatch": "grouped"}),
    (QWEN3, (1, RANKS), DECODE_32K, {"n_kv_heads": 1}),
    (QWEN3, (RANKS, 1), DECODE_32K, {}),
]


def _collective_id(case):
    """arch-shape, then the mesh where overrides follow or an earlier
    case has the same arch and shape, then the overrides."""
    arch, mesh, shape, repl = case
    again = any(c[0] == arch and c[2] == shape
                for c in COLLECTIVE_CASES[:COLLECTIVE_CASES.index(case)])
    return "-".join([arch, shape.name]
                    + ([f"{mesh[0]}x{mesh[1]}"] if repl or again else [])
                    + [f"{k}={v}" for k, v in repl.items()])


def _reference(arch, cases, repl=None):
    """The reference's logits (prefill, then each decode step) for each
    (B, S, T, inputs) of ``cases`` on its seed-0 weights: its ``prefill``
    and ``serve_step``, and for a step whose position is past a window
    ring's length (one row, no padding) its ``forward`` over the prompt and
    the steps' tokens (its ``serve_step`` hides in-window keys once its
    ring wraps; the port follows ``forward``, as
    ``test_torch_families.test_ring_decode_past_the_window`` holds it).
    ``repl``: overrides of the reduced config, as the ranks apply them.
    -> (params, [[logits per step] per case])."""
    jm = JaxModel(dataclasses.replace(get_config(arch).reduced(),
                                      **(repl or {})))
    params = jm.init(jax.random.PRNGKey(0))
    prefill = jax.jit(lambda p, b, c, n: jm.prefill(p, b, c, true_len=n))
    step = jax.jit(jm.serve_step)
    win = jm.cfg.attn.sliding_window
    out = []
    for B, S, T, inp in cases:
        batch = {"tokens": jnp.asarray(inp["tokens"], jnp.int32)}
        if "enc_embeds" in inp:
            batch["enc_embeds"] = jnp.asarray(inp["enc_embeds"])
        lg, cache, _ = prefill(params, batch, jm.init_cache(B, T),
                               jnp.asarray(inp["true_len"]))
        logits = [np.asarray(lg)]
        for tok in inp["steps"]:
            lg, cache, _ = step(params, cache, jnp.asarray(tok, jnp.int32))
            logits.append(np.asarray(lg))
        ring = min(T, win) if win else T
        if S + STEPS - 1 >= ring:
            assert B == 1 and "enc_embeds" not in inp
            seq = np.concatenate([inp["tokens"], inp["steps"].T], 1)
            full, _ = jax.jit(jm.forward)(params, {
                "tokens": jnp.asarray(seq, jnp.int32)})
            for i in range(1, STEPS + 1):
                if S + i - 1 >= ring:            # step i's position
                    logits[i] = np.asarray(full[:, S + i - 1])
        out.append(logits)
    return params, out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One pair of gloo ranks serves every case of ``CASES`` and counts
    the collectives of ``COLLECTIVE_CASES``, while this process runs the
    reference on the same weights and inputs. -> (the ranks' records, the
    reference's logits per case)."""
    tmp = tmp_path_factory.mktemp("serve")
    inputs = [_inputs(torch_get_config(a).reduced(), B, S, seed=i)
              for i, (a, _, B, S, _) in enumerate(CASES)]
    npz, want = {}, [None] * len(CASES)
    for arch in ARCHS:
        params = JaxModel(get_config(arch).reduced()).init(
            jax.random.PRNGKey(0))
        npz[arch] = str(tmp / f"{arch}.npz")
        np.savez(npz[arch], **dict(_flatten(jax.tree.map(np.asarray,
                                                         params))))
    cases = []
    for i, ((a, m, _, _, T), inp) in enumerate(zip(CASES, inputs)):
        np.savez(tmp / f"inputs{i}.npz", **inp)
        cases.append({"arch": a, "mesh": list(m), "T": T, "npz": npz[a],
                      "inputs": str(tmp / f"inputs{i}.npz")})
    colls = [{"arch": a, "mesh": list(m), "B": s.global_batch,
              "T": s.seq_len, "window": (torch_get_config(a).reduced()
                                         .attn.sliding_window
                                         if s.name == "long_500k" else 0),
              "repl": repl}
             for a, m, s, repl in COLLECTIVE_CASES]
    procs, out = _start_ranks("serve", {"cases": cases,
                                        "collectives": colls}, tmp,
                              worker=_WORKER)
    for arch in ARCHS:
        idx = [i for i, c in enumerate(CASES) if c[0] == arch]
        _, logits = _reference(arch, [CASES[i][2:4] + (CASES[i][4],
                                                       inputs[i])
                                      for i in idx])
        for i, lg in zip(idx, logits):
            want[i] = lg
    return _finish(procs, out), want


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_placed_serving_matches_unplaced(served, i):
    """Prefill (the last of two rows right-padded) and 3 decode steps of a
    placed reduced model over two gloo ranks: the logits (plain, full-vocabulary, the same on both ranks) and
    every cache entry equal the unplaced port's within 1e-5 of each
    tensor's largest element; the counts and positions are equal."""
    recs, _ = served
    arch, mesh, B, S, T = CASES[i]
    for rec in (r["cases"][i] for r in recs):
        assert len(rec["logit_err"]) == STEPS + 1
        assert max(rec["logit_err"]) <= SPMD_TOL, rec["logit_err"]
        bad = {k: e for k, e in rec["cache_err"].items() if e > SPMD_TOL}
        assert not bad, bad
        assert rec["counts_equal"] and rec["pos_equal"]
    assert recs[0]["cases"][i]["logits"] == recs[1]["cases"][i]["logits"]
    if B < mesh[0]:
        # context-parallel: every block of every sequence-sharded entry
        # was written, on both ranks (the cases above put positions in
        # rank 1's blocks)
        for rec in (r["cases"][i] for r in recs):
            blocks = [w for layer in rec["seq_blocks_written"] for w in layer]
            assert blocks and all(blocks), rec["seq_blocks_written"]
    pl = recs[0]["cases"][i]["placements"]         # layer 0's cache
    kv = pl["k"] if "k" in pl else pl.get("ckv")
    if kv is not None:
        # rows over the data axis, or (one row) the sequence
        assert kv[0] == ("S(1)" if B < mesh[0] else
                         "S(0)" if mesh[0] > 1 else "R"), pl


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_placed_serving_matches_reference(served, i):
    """The placed run's logits at prefill and every decode step against
    the reference's ``prefill`` / ``serve_step`` on the same weights and
    tokens (past a ring's wrap, its ``forward``: see ``_reference``),
    within ``test_kernels._tol`` for fp32."""
    recs, want = served
    got = recs[0]["cases"][i]["logits"]
    for g, w in zip(got, want[i]):
        np.testing.assert_allclose(np.asarray(g, np.float32), w,
                                   **_tol(jnp.float32))


@pytest.mark.parametrize("j", range(len(COLLECTIVE_CASES)),
                         ids=[_collective_id(c) for c in COLLECTIVE_CASES])
def test_dry_run_serving_collectives_match_the_gloo_run(served, j):
    """The dry run's placed decode step (a meta model over a fake group)
    records the kinds, counts and bytes of the collectives the two gloo
    ranks issue in the same step; the roofline then has a collective
    term."""
    recs, _ = served
    arch, mesh, shape, repl = COLLECTIVE_CASES[j]
    cfg = dataclasses.replace(torch_get_config(arch).reduced(), **repl)
    rec = dryrun.placed_collectives(cfg, shape, Mesh(("data", "model"),
                                                     mesh))
    assert recs[0]["collectives"][j] == recs[1]["collectives"][j] == rec
    assert rec["all-reduce"]["count"] > 0
    r = roofline.analyze({"n_devices": 2, "collectives": rec,
                          "cost_corrected": {"dot_flops": 1.0,
                                             "bytes_accessed": 1.0}}, 1.0)
    assert r.collective_s == sum(v["bytes"] for v in rec.values()) \
        / roofline.LINK_BW > 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dry_run_extrapolates_serving_period_groups_exactly(kind):
    """A serving step's collectives over a stack of more than two period
    groups (here 5 over a (2, 2) mesh) are the one- and two-group cuts'
    extrapolation, exactly."""
    cfg = dataclasses.replace(torch_get_config(QWEN3).reduced(), n_layers=5)
    shape = InputShape("s", 16, 4, kind)
    mesh = Mesh(("data", "model"), (2, 2))
    whole = dryrun._placed_trace(cfg, shape, mesh, False, 0)
    assert dryrun.placed_collectives(cfg, shape, mesh) == whole
    assert whole["all-reduce"]["count"] > 0


@pytest.mark.parametrize("blocks", [1, 2, 4])
@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_flash_decode_lse_merge_equals_the_unsplit_call(blocks, cap):
    """``flash_decode_ref`` with ``return_lse`` over a cache cut into 1, 2
    and 4 blocks (the lengths clamped to each block, some blocks of some
    rows empty), merged by ``spmd.merge_blocks``, equals the unsplit call;
    a row with no valid position gives lse -inf and out 0; without
    ``return_lse`` the output is the plain call's."""
    g = torch.Generator().manual_seed(blocks)
    B, H, Hkv, hd, S = 3, 8, 2, 64, 32
    q = torch.randn(B, H, hd, generator=g)
    k, v = (torch.randn(B, S, Hkv, hd, generator=g) for _ in "kv")
    lens = torch.tensor([1, 17, 32])
    want = ref.flash_decode_ref(q, k, v, lens, cap)
    out, lse = ref.flash_decode_ref(q, k, v, lens, cap, return_lse=True)
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-5)
    n = S // blocks
    parts = [ref.flash_decode_ref(q, k[:, i * n:(i + 1) * n],
                                  v[:, i * n:(i + 1) * n],
                                  torch.clamp(lens - i * n, 0, n), cap,
                                  return_lse=True) for i in range(blocks)]
    merged = spmd.merge_blocks(torch.stack([p[0] for p in parts]),
                           torch.stack([p[1] for p in parts]))
    torch.testing.assert_close(merged, want, atol=1e-6, rtol=1e-5)
    assert torch.isfinite(merged).all()
    torch.testing.assert_close(
        torch.logsumexp(torch.stack([p[1] for p in parts]), 0), lse,
        atol=1e-5, rtol=1e-6)
    empty, else_ = ref.flash_decode_ref(q, k, v, torch.zeros(B), cap,
                                        return_lse=True)
    assert torch.equal(empty, torch.zeros_like(q))
    assert bool((else_ == -torch.inf).all())
