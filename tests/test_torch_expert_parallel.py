"""Expert-parallel serving on the port, against the reference on the CPU:
``moe_ffn_sharded`` and its slot form over logical CPU shards, the
expert meshes, the ``expert_fn`` seam of ``Model``, the sharded runtime's
copies of the reference's host policy, and the launcher at D > 1.

The reference shards over forced host devices, which must be set before
JAX first initializes: its D > 1 runs (``moe_ffn_sharded`` at D = 2 and 4,
a ``JaxModelServer``'s stats keys, and its launcher at three settings)
run in subprocesses, started together. Reduced qwen3-moe: 2 MoE layers x
4 experts, fp32. The card runs are in ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` phase 12."""
import ast
import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.moe_ffn import _grouped_ffn_jnp
from repro.kernels.moe_ffn import moe_ffn_sharded as jax_moe_ffn_sharded
from repro.launch import mesh as jax_mesh
from repro.launch.mesh import make_expert_mesh as jax_make_expert_mesh
from repro.models import Model as JaxModel
from repro.models.moe import grouped_expert_ffn
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.slot_cache import EXPERT_WEIGHT_NAMES, quantize_weight
from repro_torch.kernels import ops
from repro_torch.kernels.moe_ffn import (moe_ffn_sharded,
                                         moe_ffn_sharded_slots)
from repro_torch.launch import mesh
from repro_torch.launch import serve as torch_serve
from repro_torch.models import Model
from repro_torch.params import from_reference
from repro_torch.serving import EngineConfig, TorchModelServer
from repro_torch.serving.slot_runtime import ShardedSlotRuntime

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
ARCH = "qwen3-moe-235b-a22b"
TOL = dict(atol=1e-4, rtol=1e-4)     # fp32, sums in other orders
FFN_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_kernels.py::_tol, fp32
LAUNCHES = {  # the launcher settings held against the reference
    "d2": ["--resident-fraction", "0.5", "--devices", "2"],
    "d4_int8": ["--resident-fraction", "0.5", "--devices", "4",
                "--transfer-dtype", "int8"],
    "all_resident_d2": ["--devices", "2"]}
LAUNCH_FLAGS = ["--arch", ARCH, "--reduced", "--requests", "4"]
# FFN cases: (name, act, E, C, d, f); C = 6 at D = 4 takes the pad path
FFN_CASES = [("gated", "swiglu", 8, 6, 16, 32), ("ungated", "relu2", 4, 6,
                                                 16, 32)]


def _ffn_operands(act, E, C, d, f, seed=0):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((E, C, d)).astype(np.float32)

    def mk(*s):
        return (0.1 * rng.standard_normal(s)).astype(np.float32)
    wg = mk(E, d, f) if act == "swiglu" else None
    return xg, wg, mk(E, d, f), mk(E, f, d)


_REF_FFN = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.kernels.moe_ffn import moe_ffn_sharded
from repro.launch.mesh import make_expert_mesh
from repro.models import Model
from repro.serving import EngineConfig, SchedulerConfig
from repro.serving.engine import JaxModelServer

assert len(jax.devices()) == 4
inp = np.load(sys.argv[1])
out = {}
for name in ("gated", "ungated"):
    xg, wu, wd = (jnp.asarray(inp[f"{name}_{k}"]) for k in ("x", "u", "d"))
    wg = jnp.asarray(inp[f"{name}_g"]) if f"{name}_g" in inp else None
    act = "swiglu" if wg is not None else "relu2"
    for D in (2, 4):
        out[f"{name}_d{D}"] = np.asarray(moe_ffn_sharded(
            xg, wg, wu, wd, mesh=make_expert_mesh(D), impl="jnp", act=act))
np.savez(sys.argv[2], **out)

jm = Model(get_config("qwen3-moe-235b-a22b").reduced())
params = jm.init(jax.random.PRNGKey(0))
srv = JaxModelServer(
    EngineConfig(arch=jm.cfg, gpu_cache_experts=4, dram_cache_experts=8,
                 scheduler=SchedulerConfig(max_batch=4), n_devices=2,
                 resident_fraction=0.5),
    jm, params, n_slots=4, cache_len=32)
srv.generate(np.ones((1, 4), np.int32), max_new_tokens=2)
st = srv.stats()
print("STATS_KEYS " + ",".join(sorted(st)))
print("PER_DEVICE_KEYS " + ",".join(sorted(st["per_device"][0])))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's D > 1 runs, four subprocesses at once: the sharded
    FFN at D = 2 and 4 over 4 forced host devices with a D = 2 server's
    stats keys, and its launcher at each ``LAUNCHES`` setting (it forces
    the host devices itself). -> {"ffn": {case: array}, "stats_keys",
    "per_device_keys", "launch": {setting: stdout}}."""
    tmp = tmp_path_factory.mktemp("ep_reference")
    inputs = {}
    for name, act, E, C, d, f in FFN_CASES:
        xg, wg, wu, wd = _ffn_operands(act, E, C, d, f)
        inputs.update({f"{name}_x": xg, f"{name}_u": wu, f"{name}_d": wd})
        if wg is not None:
            inputs[f"{name}_g"] = wg
    np.savez(tmp / "in.npz", **inputs)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    procs = {"ffn": subprocess.Popen(
        [sys.executable, "-c", _REF_FFN, str(tmp / "in.npz"),
         str(tmp / "out.npz")],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    for key, flags in LAUNCHES.items():
        procs[key] = subprocess.Popen(
            [sys.executable, "-m", "repro.launch.serve", *LAUNCH_FLAGS,
             *flags], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    outs = {}
    for key, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{key}: {stdout[-2000:]}" \
                                     f"{stderr[-3000:]}"
        outs[key] = stdout
    keys = dict(line.split(" ", 1) for line in outs["ffn"].splitlines()
                if line.startswith(("STATS_KEYS", "PER_DEVICE_KEYS")))
    with np.load(tmp / "out.npz") as z:
        ffn = {k: z[k] for k in z.files}
    return {"ffn": ffn, "stats_keys": keys["STATS_KEYS"].split(","),
            "per_device_keys": keys["PER_DEVICE_KEYS"].split(","),
            "launch": {k: outs[k] for k in LAUNCHES}}


@pytest.fixture(scope="module")
def ref_params():
    jm = JaxModel(get_config(ARCH).reduced())
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, jax.tree.map(np.asarray, params)


def _port_model(np_params):
    return from_reference(
        Model(torch_get_config(ARCH).reduced(), device="cpu"), np_params)


def _torch(a):
    return None if a is None else torch.from_numpy(a)


# -- moe_ffn_sharded ----------------------------------------------------------

@pytest.mark.parametrize("case", FFN_CASES, ids=lambda c: c[0])
def test_moe_ffn_sharded_matches_reference(reference, case):
    """The port at D = 1, 2, 4 on logical CPU shards against the
    reference's plain grouped FFN and its ``moe_ffn_sharded`` at D = 1
    (in this process) and at D = 2 and 4 (over forced host devices)."""
    name, act, E, C, d, f = case
    ops_np = _ffn_operands(act, E, C, d, f)
    want = {1: np.asarray(jax_moe_ffn_sharded(
        *(None if a is None else jnp.asarray(a) for a in ops_np),
        mesh=jax_make_expert_mesh(1), impl="jnp", act=act))}
    plain = np.asarray(_grouped_ffn_jnp(
        *(None if a is None else jnp.asarray(a) for a in ops_np), act=act))
    np.testing.assert_array_equal(want[1], plain)
    for D in (2, 4):
        want[D] = reference["ffn"][f"{name}_d{D}"]
    xg, wg, wu, wd = map(_torch, ops_np)
    for D, ref in want.items():
        got = moe_ffn_sharded(xg, wg, wu, wd, act=act,
                              mesh=mesh.make_expert_mesh(D, "cpu"))
        assert got.shape == (E, C, d)
        np.testing.assert_allclose(got.numpy(), ref, **FFN_TOL)


@pytest.mark.parametrize("case", FFN_CASES, ids=lambda c: c[0])
def test_moe_ffn_sharded_is_exact(case):
    """D > 1 equals D = 1 and the unsharded launch exactly, C = 6 at D = 4
    included (C padded to 8); D must divide E."""
    name, act, E, C, d, f = case
    xg, wg, wu, wd = map(_torch, _ffn_operands(act, E, C, d, f, seed=1))
    one = ops.moe_expert_ffn(xg, wg, wu, wd, act=act)
    for D in (1, 2, 4):
        got = moe_ffn_sharded(xg, wg, wu, wd, act=act,
                              mesh=mesh.make_expert_mesh(D, "cpu"))
        assert torch.equal(got, one), D
    with pytest.raises(ValueError, match="must divide"):
        moe_ffn_sharded(xg[:3], None if wg is None else wg[:3], wu[:3],
                        wd[:3], act=act, mesh=mesh.make_expert_mesh(2, "cpu"))


def _slot_buffers(wire, d, f, n_slots, gated, seed=2):
    """Slot buffers of ``n_slots`` random experts in the wire dtype (fp32:
    the master dtype here), each slot quantized on its own as the host
    store does, int8 with its scale rows."""
    rng = np.random.default_rng(seed)
    shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    bufs = {}
    for name in EXPERT_WEIGHT_NAMES:
        if name == "w_gate" and not gated:
            continue
        w = torch.from_numpy((0.1 * rng.standard_normal(
            (n_slots,) + shapes[name])).astype(np.float32))
        if wire == "fp32":
            bufs[name] = w
            continue
        qs = [quantize_weight(w[i], wire) for i in range(n_slots)]
        bufs[name] = torch.stack([q for q, _ in qs])
        if qs[0][1] is not None:
            bufs[name + "_scale"] = torch.stack([s for _, s in qs])
    return bufs


@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "relu2"])
@pytest.mark.parametrize("wire", ["fp32", "fp16", "int8"])
def test_moe_ffn_sharded_slots_is_exact(wire, gated):
    """The slot form at D = 2 and 4 equals the unsharded
    ``ops.moe_expert_ffn_slots`` exactly: over shared buffers with each
    shard's slice of the table, and over per-shard buffers holding only
    that shard's experts (the runtime's layout)."""
    act = "swiglu" if gated else "relu2"
    E, C, d, f, n = 8, 6, 16, 32, 12
    bufs = _slot_buffers(wire, d, f, n, gated)
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.permutation(n)[:E].astype(np.int32))
    xg = torch.from_numpy(rng.standard_normal((E, C, d)).astype(np.float32))
    xg[:, 4:] = 0.0                      # unrouted rows, as the dispatch
    out_dtype = torch.float32
    want = ops.moe_expert_ffn_slots(xg, bufs, table, act=act,
                                    out_dtype=out_dtype)
    for D in (2, 4):
        m = mesh.make_expert_mesh(D, "cpu")
        Eb = E // D
        shared = moe_ffn_sharded_slots(
            xg, [bufs] * D, [table[i * Eb:(i + 1) * Eb] for i in range(D)],
            mesh=m, act=act, out_dtype=out_dtype)
        own = [{k: v.index_select(0, table[i * Eb:(i + 1) * Eb].long())
                for k, v in bufs.items()} for i in range(D)]
        rows = [torch.arange(Eb, dtype=torch.int32)] * D
        local = moe_ffn_sharded_slots(xg, own, rows, mesh=m, act=act,
                                      out_dtype=out_dtype)
        assert torch.equal(shared, want) and torch.equal(local, want), D
        assert torch.equal(want[:, 4:], torch.zeros_like(want[:, 4:]))


# -- the meshes ---------------------------------------------------------------

def test_make_expert_mesh_bounds(monkeypatch):
    """CPU: n logical shards, n >= 1. CUDA: the first n distinct cards,
    and more than there are raises (here: none without a GPU)."""
    m = mesh.make_expert_mesh(4, "cpu")
    assert m.axis_names == ("expert",) and m.shape == {"expert": 4}
    assert m.devices == (torch.device("cpu"),) * 4
    assert mesh.make_expert_mesh(device="cpu").shape == {"expert": 1}
    assert mesh.axis_size(m, "expert") == 4 and mesh.axis_size(m, "data") == 1
    for bad in (0, -1):
        with pytest.raises(ValueError, match="1 <= n_devices"):
            mesh.make_expert_mesh(bad, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="<= 0 available devices, got 1"):
        mesh.make_expert_mesh(1, "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.make_expert_mesh(device="cuda").devices == (
        torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="<= 2 available devices, got 4"):
        mesh.make_expert_mesh(4, "cuda")
    # one card repeated: the form the card's smoke run builds by hand
    assert mesh.ExpertMesh(["cuda:0"] * 3).shape == {"expert": 3}
    with pytest.raises(ValueError):
        mesh.ExpertMesh([])


def test_expert_meshes_match_reference(monkeypatch):
    """``expert=True`` production and debug meshes: the reference's axis
    names and sizes (its ``jax.make_mesh`` calls read without building
    256-device meshes)."""
    monkeypatch.setattr(jax_mesh.jax, "make_mesh",
                        lambda shape, names: dict(zip(names, shape)))
    for fn in ("make_production_mesh", "make_debug_mesh"):
        for multi_pod in (False, True):
            for expert in (False, True):
                want = getattr(jax_mesh, fn)(multi_pod=multi_pod,
                                             expert=expert)
                got = getattr(mesh, fn)(multi_pod=multi_pod, expert=expert)
                assert got.shape == want, (fn, multi_pod, expert)
                assert mesh.batch_axes(got) == (
                    ("pod", "data") if multi_pod else ("data",))


# -- the expert_fn seam -------------------------------------------------------

def test_expert_fn_seam_matches_reference(ref_params):
    """``forward``, padded ``prefill`` and gated ``serve_step`` with an
    ``expert_fn`` (twice the plain grouped FFN) give the reference's
    logits with the same function, and differ from the plain model's."""
    jm, params, np_params = ref_params
    tm = _port_model(np_params)
    act = jm.cfg.act

    def jfn(xg, p):
        return 2.0 * grouped_expert_ffn(xg, p, act)

    def tfn(xg, p):
        return 2.0 * ops.moe_expert_ffn(xg, p.w_gate, p.w_up, p.w_down,
                                        act=act)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jm.cfg.vocab, (2, 10))
    jl, jaux = jax.jit(lambda p, b: jm.forward(p, b, expert_fn=jfn))(
        params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tl, taux = tm.forward({"tokens": torch.from_numpy(toks)},
                              expert_fn=tfn)
        plain, _ = tm.forward({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(taux["counts"].numpy(),
                                  np.asarray(jaux["counts"]))
    assert not np.allclose(plain.numpy(), tl.numpy(), **TOL)

    S, P, L = 7, 8, 16
    padded = np.zeros((1, P), np.int64)
    padded[0, :S] = toks[0, :S]
    jprefill = jax.jit(lambda p, b, c: jm.prefill(p, b, c, expert_fn=jfn,
                                                  true_len=S))
    jl, jone, _ = jprefill(params, {"tokens": jnp.asarray(padded)},
                           jm.init_cache(1, L))
    with torch.inference_mode():
        tl, tone, _ = tm.prefill({"tokens": torch.from_numpy(padded)},
                                 tm.init_cache(1, L), expert_fn=tfn,
                                 true_len=S)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    jpool, tpool = jm.init_cache(2, L), tm.init_cache(2, L)
    jpool = jm.write_slot(jpool, jone, 1)
    tm.write_slot(tpool, tone, 1)
    tok = np.array([0, int(tl[0].argmax())])
    active = np.array([False, True])
    step = jax.jit(lambda p, c, t, a: jm.serve_step(p, c, t, expert_fn=jfn,
                                                    active=a))
    with torch.inference_mode():
        for _ in range(3):
            jl, jpool, jaux = step(params, jpool, jnp.asarray(tok, jnp.int32),
                                   jnp.asarray(active))
            tl, tpool, taux = tm.serve_step(
                tpool, torch.from_numpy(tok), expert_fn=tfn,
                active=torch.from_numpy(active))
            np.testing.assert_allclose(tl.numpy()[1], np.asarray(jl)[1],
                                       **TOL)
            np.testing.assert_array_equal(taux["counts"].numpy(),
                                          np.asarray(jaux["counts"]))
            tok = tl.argmax(-1).numpy()


def test_expert_fn_seam_grouped_dispatch():
    """Under ``moe_dispatch="grouped"`` the ``expert_fn`` runs once a
    sequence on its (E, C, d) blocks; the plain FFN as ``expert_fn``
    gives the plain grouped dispatch's output exactly."""
    import dataclasses
    from repro_torch.models import moe
    cfg = dataclasses.replace(torch_get_config(ARCH).reduced(),
                              moe_dispatch="grouped")
    tm = Model(cfg, device="cpu").init(3)
    p = tm.layers[0].moe
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 5, cfg.d_model)).astype(np.float32))
    calls = []

    def fn(xg, p_):
        calls.append(tuple(xg.shape))
        return ops.moe_expert_ffn(xg, p_.w_gate, p_.w_up, p_.w_down,
                                  act=cfg.act)
    y, aux = moe.moe_ffn(p, cfg, x, expert_fn=fn)
    want, waux = moe.moe_ffn(p, cfg, x)
    C = moe.capacity(5, cfg.moe)
    assert calls == [(cfg.moe.n_experts, C, cfg.d_model)] * 3
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
    assert torch.equal(aux["counts"], waux["counts"])


# -- the sharded runtime ------------------------------------------------------

def _methods(path, cls):
    """{name: ast dump} of the methods of class ``cls`` in ``path``,
    docstrings and comments dropped, ``repro.`` read as ``repro_torch.``."""
    text = re.sub(r"\brepro\.", "repro_torch.", path.read_text())
    tree = ast.parse(text)
    klass = next(n for n in tree.body
                 if isinstance(n, ast.ClassDef) and n.name == cls)
    out = {}
    for node in [klass] + klass.body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant):
            node.body = node.body[1:] or [ast.Pass()]
    for node in klass.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = ast.dump(node)
    return out, ast.dump(klass)


@pytest.mark.parametrize("name", ["_partition_targets", "sync_residency",
                                  "_stage_plan", "flush_pending", "_ensure"])
def test_sharded_host_policy_is_the_reference_copy(name):
    """The sharded runtime's host policy (residency split by placement
    home, the per-layer upload plan, demand uploads by home) is the
    reference's code."""
    port, _ = _methods(SRC / "repro_torch/serving/slot_runtime.py",
                       "ShardedSlotRuntime")
    ref, _ = _methods(SRC / "repro/serving/slot_runtime.py",
                      "ShardedSlotRuntime")
    assert port[name] == ref[name]


def _server(np_params, n_devices, **kw):
    cfg = EngineConfig(arch=torch_get_config(ARCH).reduced(),
                       gpu_cache_experts=4, dram_cache_experts=8,
                       n_devices=n_devices, **kw)
    return TorchModelServer(cfg, _port_model(np_params), n_slots=4,
                            cache_len=32, device="cpu")


def test_sharded_server_stats_keys_match_reference(reference, ref_params):
    """A D = 2 server at rf 0.5: the reference's ``stats()`` keys and
    per-device keys; the shards' counters sum to the totals; one cache per
    shard of ``max(slots // D, E / D)`` slots."""
    srv = _server(ref_params[2], 2, resident_fraction=0.5)
    rt = srv.slot_runtime
    assert isinstance(rt, ShardedSlotRuntime)
    assert [c.n_slots for c in rt.slot_caches] == [2, 2]
    srv.generate(np.ones((1, 4), np.int32), max_new_tokens=2)
    st = srv.stats()
    assert sorted(st) == reference["stats_keys"]
    assert sorted(st["per_device"][0]) == reference["per_device_keys"]
    assert st["n_devices"] == 2
    for key in ("slot_hits", "slot_misses", "demand_uploads",
                "prefetch_uploads", "upload_bytes", "weight_slots"):
        assert st[key] == sum(d[key] for d in st["per_device"]), key
    assert st["upload_bytes"] == st["wire_expert_bytes"] * (
        st["demand_uploads"] + st["prefetch_uploads"])


def test_sharded_runtime_refusals(ref_params):
    import dataclasses
    cfg = torch_get_config(ARCH).reduced()
    model = _port_model(ref_params[2])
    kw = dict(n_pool_slots=2, n_weight_slots=8)
    grouped = Model(dataclasses.replace(cfg, moe_dispatch="grouped"),
                    device="cpu").init(0)
    with pytest.raises(NotImplementedError, match="global dispatch"):
        ShardedSlotRuntime(grouped, mesh=mesh.make_expert_mesh(2, "cpu"),
                           placement=None, **kw)
    with pytest.raises(ValueError, match="must divide"):
        ShardedSlotRuntime(model, mesh=mesh.make_expert_mesh(3, "cpu"),
                           placement=None, **kw)


def test_sharded_server_needs_cuda_unless_asked_for_cpu(monkeypatch,
                                                        ref_params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EngineConfig(arch=torch_get_config(ARCH).reduced(),
                       gpu_cache_experts=4, dram_cache_experts=8,
                       n_devices=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchModelServer(cfg, _port_model(ref_params[2]))
    args = torch_serve.parse_args(["--reduced", "--devices", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_serve.serve(args, torch_get_config(ARCH).reduced())


# -- the launcher -------------------------------------------------------------

REPORT = ("req ", "total:", "tiers:", "slots:", "devices:", "eamc:",
          "predictor:")


def _report(text):
    """Report lines without the ``compiles=`` tail and the wall-clock
    ``demand-stall=``."""
    out = []
    for line in text.splitlines():
        if line.startswith(REPORT):
            line = re.sub(r", compiles=.*$", "", line)
            out.append(re.sub(r"demand-stall=\S+ \(\S+\) ", "", line))
    return out


def _port_launch(np_params, flags):
    cfg = torch_get_config(ARCH).reduced()
    args = torch_serve.parse_args(LAUNCH_FLAGS + flags + ["--device", "cpu"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = torch_serve.serve(args, cfg, _port_model(np_params))
    return _report(buf.getvalue()), out


@pytest.mark.parametrize("setting", list(LAUNCHES))
def test_launcher_matches_reference_at_d_gt_1(reference, ref_params,
                                              setting):
    """The port's launcher over logical CPU shards prints the reference's
    report lines, the ``devices:`` line (with rebalances > 0) included,
    and its tokens are the port's D = 1 tokens."""
    flags = LAUNCHES[setting]
    got, out = _port_launch(ref_params[2], flags)
    want = _report(reference["launch"][setting])
    assert len(want) == 4 + 6
    assert got == want
    devices = next(ln for ln in got if ln.startswith("devices:"))
    D = int(re.search(r"D=(\d+)", devices).group(1))
    assert int(re.search(r"rebalances=(\d+)", devices).group(1)) > 0
    assert out["server"].slot_runtime.mesh.shape == {"expert": D}
    one = [f if f != str(D) else "1" for f in flags]
    _, out1 = _port_launch(ref_params[2], one)
    assert out1["tokens"] == out["tokens"]
