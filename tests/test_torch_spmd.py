"""The sharded training step (``launch/train.py --mesh debug``) on the CPU:
two gloo ranks in separate processes, as ``torch.distributed.run`` starts
them, against the reference's ``--mesh debug`` over two forced host
devices, against the unsharded port, and the dry run's collectives against
those the ranks issue."""
import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro_torch.configs import get_config as torch_get_config
from repro_torch.config import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import local_shape, param_spec

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
QWEN3 = "qwen3-moe-235b-a22b"
RANKS = 2

# what each rank runs: argv[1] is the mode, argv[2] a JSON of arguments;
# each rank writes <out>.<rank>.json
_WORKER = r"""
import contextlib, io, json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.configs import get_config
from repro_torch.launch import sharding, spmd
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model
from repro_torch.params import from_reference
from repro_torch.train.loop import make_train_step, to_batch
from repro_torch.train.optim import OptConfig, adamw_init

mode, a = sys.argv[1], json.loads(sys.argv[2])
out = {}


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


def rep(t, mesh):
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def placed(model, sizes=None):
    spmd.start("cpu")
    mesh = (spmd.train_mesh() if sizes is None
            else Mesh(("data", "model"), tuple(sizes)))
    return sharding.place(model, spmd.device_mesh(mesh, "cpu"), mesh)


if mode == "launcher":
    args = launcher.parse_args(a["argv"])
    cfg = launcher.config(args)
    with np.load(a["npz"]) as f:
        tree = unflatten({k: f[k] for k in f.files})
    model = from_reference(Model(cfg, device="cpu"), tree)
    buf = io.StringIO()
    spmd.start("cpu")
    with contextlib.redirect_stdout(buf):
        res = launcher.train(args, cfg, model)
    out["stdout"] = buf.getvalue()
    out["local"] = {n: list(p.to_local().shape)
                    for n, p in model.named_parameters()}
    out["placements"] = {n: [q.dim if q.is_shard() else None
                             for q in p.placements]
                         for n, p in model.named_parameters()}
    out["full"] = {n: list(p.shape) for n, p in model.named_parameters()}
    out["losses"] = res["losses"]
elif mode == "grads":
    cfg = get_config(a["arch"]).reduced()
    rng = np.random.default_rng(0)
    batch = to_batch({"tokens": rng.integers(0, cfg.vocab, (2, 16))}, "cpu")

    def loss_and_grads(model):
        model.trainable()
        b = batch
        if spmd.is_placed(*model.parameters()):
            b = sharding.place_batch(batch, model.embed.device_mesh)
        with spmd.step_context(model):
            loss = model.loss(b, remat=True)
            loss.backward()
        grads = {}
        for n, p in model.named_parameters():
            g = p.grad
            grads[n] = g.full_tensor() if isinstance(g, DTensor) else g
        return spmd.local(loss.detach()), grads

    l0, g0 = loss_and_grads(Model(cfg, device="cpu").init(0))
    model = placed(Model(cfg, device="cpu").init(0), a["mesh"])
    l1, g1 = loss_and_grads(model)
    out["loss"] = [float(l0), float(l1)]
    out["grad_err"] = {n: float((g1[n] - g0[n]).abs().max())
                       for n in g0}
    out["grad_max"] = {n: float(g0[n].abs().max()) for n in g0}
    # each kernel site of a placed layer against the same function on the
    # full tensors (the same products per expert / head / channel)
    from repro_torch.models import mamba, moe, rwkv6
    g = torch.Generator().manual_seed(1)
    full = {}

    def first(kind):
        return next((b for b in model.layers if hasattr(b, kind)), None)
    layer = first("moe")
    if layer is not None:
        E, d = cfg.moe.n_experts, cfg.d_model
        xg = torch.randn(E, 5, d, generator=g)
        ws = {n: getattr(layer.moe, n).full_tensor().detach()
              for n in ("w_gate", "w_up", "w_down")}
        want = moe.ops.moe_expert_ffn(xg, ws["w_gate"], ws["w_up"],
                                      ws["w_down"], act=cfg.act)

        def ffn(xg, w_gate, w_up, w_down):
            return moe.ops.moe_expert_ffn(xg, w_gate, w_up, w_down,
                                          act=cfg.act)
        got = spmd.site(ffn, (0, 0, 0, 0), (0,), xg, layer.moe.w_gate,
                        layer.moe.w_up, layer.moe.w_down)
        full["B1"] = bool(torch.equal(got.full_tensor(), want))
        out["B1_local_experts"] = int(got.to_local().shape[0])
    layer = first("rwkv")
    if layer is not None:
        H, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
        r, k, v = (torch.randn(2, 7, H, hd, generator=g) for _ in range(3))
        w = torch.rand(2, 7, H, hd, generator=g) * 0.5 + 0.4
        u = torch.randn(H, hd, generator=g)
        want = rwkv6._recurrence(r, k, v, w, u, None)
        got = spmd.site(rwkv6._recurrence, (2, 2, 2, 2, 0, 1), (2, 1),
                        r, k, v, w, rep(u, layer.rwkv.u.device_mesh), None)
        full["B4"] = all(bool(torch.equal(x.full_tensor(), y))
                         for x, y in zip(got, want))
    layer = first("mamba")
    if layer is not None:
        from repro_torch.models.mamba import _dims
        D, N = _dims(cfg)[0], cfg.mamba.d_state
        x, dt = (torch.rand(2, 7, D, generator=g) for _ in range(2))
        A = -torch.rand(D, N, generator=g) - 0.5
        Bm, Cm = (torch.randn(2, 7, N, generator=g) for _ in range(2))
        h0 = torch.zeros(2, D, N)
        want = mamba._scan(x, dt, A, Bm, Cm, h0)
        got = spmd.site(mamba._scan, (2, 2, 0, None, None, 1), (2, 1),
                        rep(x, layer.mamba.A_log.device_mesh), dt, A, Bm,
                        Cm, h0)
        full["B5"] = all(bool(torch.equal(x.full_tensor(), y))
                         for x, y in zip(got, want))
    out["sites"] = full
elif mode == "collectives":
    cfg = get_config(a["arch"]).reduced()
    model = placed(Model(cfg, device="cpu").init(0), a.get("mesh"))
    step = make_train_step(model, OptConfig(), remat=True)
    opt = adamw_init(dict(model.named_parameters()))
    B, S = a["batch"]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    counter = spmd.CollectiveCounter()
    with counter:
        step(opt, {"tokens": tokens})
    out["collectives"] = counter.record()
with open(f"{a['out']}.{dist.get_rank()}.json", "w") as f:
    json.dump(out, f)
spmd.stop()
"""


# the reference's launcher with --mesh debug. jax 0.9's make_mesh gives
# Explicit axes, under which the launcher's embedding gather raises
# ShardingTypeError; Auto axes give the GSPMD partitioning it was written
# for (ROADMAP, "Found in the reference")
_REFERENCE = """
import functools, jax
from jax.sharding import AxisType
jax.make_mesh = functools.partial(jax.make_mesh,
                                  axis_types=(AxisType.Auto,) * 2)
from repro.launch import train
train.main(["--reduced", "--steps", "3", "--mesh", "debug"])
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_ranks(mode, args, tmp_path, worker=None, ranks=RANKS):
    """Start ``ranks`` gloo ranks running ``mode`` of ``worker`` (default
    this file's); -> (processes, out)."""
    out = str(tmp_path / mode)
    port = _free_port()
    procs = []
    for rank in range(ranks):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_"))}
        env.update(PYTHONPATH=str(REPO / "src"), RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE=str(ranks),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", worker or _WORKER, mode,
             json.dumps(dict(args, out=out))], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs, out


def _finish(procs, out):
    for p in procs:
        so, se = p.communicate(timeout=240)
        assert p.returncode == 0, so[-2000:] + se[-4000:]
    return [json.loads(Path(f"{out}.{r}.json").read_text())
            for r in range(len(procs))]


def _lines(text):
    return [tuple(float(v) for v in re.findall(
        r"loss (\S+) gnorm (\S+)", line)[0])
        for line in text.splitlines() if line.startswith("step")]


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def test_sharded_launcher_matches_reference(tmp_path):
    """``--mesh debug --reduced --steps 3`` over two gloo ranks from the
    reference's seed-0 weights prints the reference's ``--mesh debug``
    lines over two forced host devices, within
    ``test_launcher_matches_reference``'s tolerances; each rank holds the
    local shape of every parameter's spec, laid out on the model axis."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    params = JaxModel(get_config(QWEN3).reduced()).init(
        jax.random.PRNGKey(0))
    npz = str(tmp_path / "ref.npz")
    np.savez(npz, **dict(_flatten(jax.tree.map(np.asarray, params))))
    ck = str(tmp_path / "ck.npz")
    procs, out = _start_ranks("launcher", {"npz": npz, "argv": [
        "--reduced", "--steps", "3", "--device", "cpu", "--mesh", "debug",
        "--ckpt", ck]}, tmp_path)
    so, se = ref.communicate(timeout=240)
    assert ref.returncode == 0, se[-3000:]
    jax_lines = _lines(so)
    recs = _finish(procs, out)
    lines = _lines(recs[0]["stdout"])
    assert len(lines) == len(jax_lines) == 3
    assert not _lines(recs[1]["stdout"])           # rank 0 prints
    np.testing.assert_allclose(lines[0], jax_lines[0], atol=1.5e-3, rtol=0)
    np.testing.assert_allclose(lines[1:], jax_lines[1:], rtol=2e-3)
    assert recs[0]["losses"] == recs[1]["losses"]
    assert "saved params to" in recs[0]["stdout"]
    mesh = Mesh(("data", "model"), (1, RANKS))
    sharded = 0
    for rec in recs:
        for name, full in rec["full"].items():
            spec = param_spec(name, tuple(full), mesh)
            assert tuple(rec["local"][name]) == local_shape(full, spec,
                                                            mesh), name
            want = spec.index("model") if "model" in spec else None
            assert rec["placements"][name] == [None, want], name
            sharded += "model" in spec
    assert sharded > len(recs[0]["full"])          # experts, heads, vocab
    with np.load(ck) as f:
        assert {n: list(f[n].shape) for n in recs[0]["full"]} \
            == recs[0]["full"]


# the families whose kernel sites a placed step runs: B1 (qwen3-moe), B4
# and B4-bwd (rwkv6), B5 and B5-bwd with B1 (jamba); fp32 on the CPU.
# The loss and every gradient of the 2-rank step against one rank's
# unplaced step: sums split over ranks reassociate in fp32, so each
# gradient is held to 1e-5 of its tensor's largest element
SPMD_TOL = {QWEN3: 1e-5, "rwkv6-7b": 1e-5, "jamba-1.5-large-398b": 1e-5}


@pytest.mark.parametrize("mesh", [(1, RANKS), (RANKS, 1)],
                         ids=["model", "data"])
@pytest.mark.parametrize("arch", list(SPMD_TOL))
def test_sharded_step_matches_unsharded(arch, mesh, tmp_path):
    """A placed reduced model's loss and every gradient over two gloo ranks
    equal the unplaced model's within ``SPMD_TOL``: on the (1, 2) mesh of
    ``--mesh debug`` (experts, heads, channels over the model axis) and on
    a (2, 1) one (the batch's rows over the data axis: the kernel sites'
    replicated parameters sum their gradients over it); each kernel site
    (``local_map`` over experts, heads or channels) gives the unsharded
    function's bits."""
    recs = _finish(*_start_ranks("grads", {"arch": arch, "mesh": mesh},
                                 tmp_path))
    for rec in recs:
        l0, l1 = rec["loss"]
        assert abs(l1 - l0) <= 1e-6 * abs(l0), (l0, l1)
        for n, err in rec["grad_err"].items():
            assert err <= SPMD_TOL[arch] * max(rec["grad_max"][n], 1e-6), \
                (n, err, rec["grad_max"][n])
        sites = rec["sites"]
        want = {QWEN3: {"B1"}, "rwkv6-7b": {"B4"},
                "jamba-1.5-large-398b": {"B1", "B5"}}[arch]
        assert set(sites) == want and all(sites.values()), sites
    if "B1" in want:
        E = torch_get_config(arch).reduced().moe.n_experts
        assert recs[0]["B1_local_experts"] == E // mesh[1]


def test_dry_run_collectives_match_the_gloo_run(tmp_path):
    """The dry run's record of reduced qwen3-moe's train step placed over a
    fake (1, 2) mesh has the kinds, counts and bytes of the collectives
    the two gloo ranks issue in the same step."""
    B, S = 2, 16
    procs, out = _start_ranks("collectives", {"arch": QWEN3,
                                              "batch": [B, S]}, tmp_path)
    cfg = torch_get_config(QWEN3).reduced()
    rec = dryrun.placed_collectives(cfg, InputShape("t", S, B, "train"),
                                    Mesh(("data", "model"), (1, RANKS)))
    recs = _finish(procs, out)
    assert recs[0]["collectives"] == recs[1]["collectives"] == rec
    assert sum(v["count"] for v in rec.values()) > 0


def test_dry_run_collectives_match_the_gloo_run_over_the_data_axis(
        tmp_path):
    """The same on a (2, 1) mesh (the batch's rows over the data axis):
    the global MoE dispatch gathers the rows and the gates to every rank,
    and the experts' gradients are whole on each; the dry run's kinds,
    counts and bytes equal the two gloo ranks'."""
    B, S = 2, 16
    procs, out = _start_ranks("collectives", {"arch": QWEN3, "batch": [B, S],
                                              "mesh": [RANKS, 1]}, tmp_path)
    cfg = torch_get_config(QWEN3).reduced()
    rec = dryrun.placed_collectives(cfg, InputShape("t", S, B, "train"),
                                    Mesh(("data", "model"), (RANKS, 1)))
    recs = _finish(procs, out)
    assert recs[0]["collectives"] == recs[1]["collectives"] == rec
    assert rec["all-gather"]["count"] > 0 and rec["all-reduce"]["count"] > 0


def test_dry_run_extrapolates_period_groups_exactly():
    """``placed_collectives`` traces a stack of more than two period
    groups cut to one and two groups: its counts and bytes equal those of
    the whole stack's trace (here 5 groups over a (2, 2) mesh)."""
    cfg = dataclasses.replace(torch_get_config(QWEN3).reduced(), n_layers=5)
    shape = InputShape("t", 16, 4, "train")
    mesh = Mesh(("data", "model"), (2, 2))
    whole = dryrun._placed_trace(cfg, shape, mesh, True, 0)
    assert dryrun.placed_collectives(cfg, shape, mesh) == whole
    assert whole["all-reduce"]["count"] > 0
