"""The port stands alone: it imports neither JAX nor the reference package,
its host-layer copies have not drifted from the reference, and its entry
points refuse to fall back to the CPU when asked for CUDA."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.examples import long_context_rwkv
from repro_torch.launch import serve as torch_serve
from repro_torch.models import Model
from repro_torch.serving import EngineConfig, TorchModelServer

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
PORT = SRC / "repro_torch"

HOST_COPIES = (
    ["config.py", "train/data.py"]
    + [f"configs/{p.name}" for p in sorted((SRC / "repro/configs")
                                           .glob("*.py"))]
    + [f"core/{n}.py" for n in ("__init__", "eam", "cache", "prefetch",
                                "predictor", "memsim", "offload",
                                "placement", "quant", "tracer")]
    + [f"serving/{n}.py" for n in ("request", "scheduler", "spec",
                                   "workload", "perf_model", "guard")]
    + [f"analysis/{n}.py" for n in ("findings", "baseline",
                                    "rules/config_drift")])


def _port_modules():
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_no_jax_and_no_reference(path):
    for mod in _imports(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(REPO)} imports {mod}"


def _code(text: str) -> ast.Module:
    """The module's AST once ``repro.`` reads ``repro_torch.``, without
    docstrings (documentation may be reworded; code may not)."""
    tree = ast.parse(re.sub(r"\brepro\.", "repro_torch.", text))
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant) \
                and isinstance(node.body[0].value.value, str):
            node.body = node.body[1:] or [ast.Pass()]
    return tree


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_layer_copy_has_not_drifted(rel):
    """Each copy has the reference's code: the same AST once ``repro.``
    reads ``repro_torch.``, apart from docstrings and comments (such as
    the lint suppressions)."""
    ref = (SRC / "repro" / rel).read_text(encoding="utf-8")
    port = (PORT / rel).read_text(encoding="utf-8")
    assert ast.dump(_code(port)) == ast.dump(_code(ref))


def test_engine_step_loop_is_the_reference_copy():
    def top_level(text):
        return {n.name: ast.dump(n) for n in _code(text).body
                if isinstance(n, (ast.ClassDef, ast.FunctionDef))}
    ref = top_level((SRC / "repro/serving/engine.py").read_text())
    port = top_level((PORT / "serving/engine.py").read_text())
    for name in ("RoutingOracle", "EngineConfig", "StepEngine",
                 "ServingEngine", "_pow2_bucket"):
        assert port[name] == ref[name], name


def test_cache_group_view_is_the_reference_copy():
    """The aggregate view over the expert-parallel runtime's per-device
    slot caches (summed counters, ``n_devices``, ``per_device``) is the
    reference's ``_CacheGroupView``."""
    def klass(text):
        return next(ast.dump(n) for n in _code(text).body
                    if isinstance(n, ast.ClassDef)
                    and n.name == "_CacheGroupView")
    assert klass((PORT / "serving/slot_runtime.py").read_text()) == \
        klass((SRC / "repro/serving/slot_runtime.py").read_text())


def test_resolve_weight_slots_is_the_reference_copy():
    """The slot-count rule (fraction, explicit count, one-layer floor) is
    ``JaxModelServer._resolve_weight_slots``'s code."""
    def method(text, cls):
        tree = _code(text)
        klass = next(n for n in tree.body
                     if isinstance(n, ast.ClassDef) and n.name == cls)
        return next(ast.dump(n) for n in klass.body
                    if isinstance(n, ast.FunctionDef)
                    and n.name == "_resolve_weight_slots")
    assert method((PORT / "serving/engine.py").read_text(),
                  "TorchModelServer") == \
        method((SRC / "repro/serving/engine.py").read_text(),
               "JaxModelServer")


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg)
    model = Model(cfg, device="cpu").init(0)
    ec = EngineConfig(arch=cfg, gpu_cache_experts=2, dram_cache_experts=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchModelServer(ec, model)
    args = torch_serve.parse_args(["--reduced"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_serve.serve(args, cfg)
    # asking for the CPU explicitly works
    srv = TorchModelServer(ec, model, device="cpu")
    out, _ = srv.generate(np.ones((1, 4), np.int32), 2)
    assert out.shape == (1, 2)


def test_rwkv_modules_are_scanned_and_default_to_cuda(monkeypatch):
    """The RWKV6 slice's modules are among those the import checks above
    cover; its entry points refuse to run without CUDA unless asked for
    the CPU; Jamba (mamba blocks) is accepted since its slice landed, and
    so is an encoder-decoder (Whisper), which also refuses the CUDA
    default without a GPU."""
    mods = _port_modules()
    for m in ("repro_torch.models.rwkv6", "repro_torch.kernels.wkv6",
              "repro_torch.examples.long_context_rwkv"):
        assert m in mods
    assert (PORT / "kernels/csrc/wkv6.cu").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("rwkv6-7b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        long_context_rwkv.main([])
    assert Model(cfg, device="cpu").init(0).layers[0].rwkv is not None
    jamba = Model(get_config("jamba-1.5-large-398b").reduced(), device="cpu")
    assert jamba.layers[0].mamba is not None
    whisper = get_config("whisper-small").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(whisper)
    assert len(Model(whisper, device="cpu").encoder) == \
        whisper.n_encoder_layers


def test_mamba_modules_are_scanned_and_default_to_cuda(monkeypatch):
    """The Jamba slice's modules are among those the import checks above
    cover, B5's source is in the tree and listed for the build, and the
    Jamba model refuses to run without CUDA unless asked for the CPU."""
    from repro_torch.kernels import build
    mods = _port_modules()
    for m in ("repro_torch.models.mamba", "repro_torch.kernels.selective_scan"):
        assert m in mods
    assert (PORT / "kernels/csrc/selective_scan.cu").exists()
    assert "selective_scan" in build.KERNELS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("jamba-1.5-large-398b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg)


def test_training_modules_are_scanned_and_default_to_cuda(monkeypatch):
    """The training slice's modules and the trace-mode engine's examples
    are among those the import checks above cover, and the train launcher
    and both examples refuse to run without CUDA unless asked for the
    CPU."""
    from repro_torch.examples import quickstart, train_moe
    from repro_torch.launch import train as torch_train
    mods = _port_modules()
    for m in ("repro_torch.train", "repro_torch.train.optim",
              "repro_torch.train.loop", "repro_torch.train.checkpoint",
              "repro_torch.launch.train", "repro_torch.examples.quickstart",
              "repro_torch.examples.train_moe"):
        assert m in mods
    assert torch_train.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: torch_train.main(["--reduced", "--steps", "1"]),
                lambda: quickstart.main([]),
                lambda: train_moe.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()


def test_launch_analysis_modules_are_scanned_and_need_no_gpu(monkeypatch):
    """The launch-time analysis modules and the kernels' meta stand-ins are
    among those the import checks above cover. ``Model`` still defaults
    to CUDA and refuses without it; the dry run takes ``device="meta"``
    and needs no GPU; a CUDA tensor never reaches a stand-in."""
    from repro_torch.kernels import ops
    mods = _port_modules()
    for m in ("repro_torch.launch.dryrun", "repro_torch.launch.cost_analysis",
              "repro_torch.launch.sharding", "repro_torch.launch.mesh",
              "repro_torch.launch.input_specs", "repro_torch.launch.roofline",
              "repro_torch.kernels.meta"):
        assert m in mods
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-moe-235b-a22b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg.reduced())
    model = Model(cfg, device="meta")
    assert next(model.parameters()).is_meta
    q = torch.empty((2, 8, 64), device="meta")
    kv = torch.empty((2, 16, 2, 64), device="meta")
    assert ops.decode_attention(q, kv, kv, 16).is_meta


def test_expert_parallel_modules_are_scanned_and_default_to_cuda(
        monkeypatch):
    """The expert-parallel pieces live in modules the import checks above
    cover; the expert mesh takes only cards that exist, and the sharded
    server refuses to run without CUDA unless asked for the CPU."""
    from repro_torch.kernels import moe_ffn
    from repro_torch.launch import mesh
    from repro_torch.serving import slot_runtime
    mods = _port_modules()
    for m in ("repro_torch.launch.mesh", "repro_torch.kernels.moe_ffn",
              "repro_torch.serving.slot_runtime"):
        assert m in mods
    assert callable(moe_ffn.moe_ffn_sharded)
    assert callable(moe_ffn.moe_ffn_sharded_slots)
    assert issubclass(slot_runtime.ShardedSlotRuntime,
                      slot_runtime.SlotStreamRuntime)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="available devices"):
        mesh.make_expert_mesh(2, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    ec = EngineConfig(arch=cfg, gpu_cache_experts=2, dram_cache_experts=4,
                      n_devices=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchModelServer(ec, Model(cfg, device="cpu").init(0))
    srv = TorchModelServer(ec, Model(cfg, device="cpu").init(0),
                           device="cpu")
    assert isinstance(srv.slot_runtime, slot_runtime.ShardedSlotRuntime)


def test_analysis_source_is_the_reference_with_its_own_prefix():
    """The port's linter reads ``# torch-lint:`` directives where the
    reference's reads ``# repro-lint:``, and is otherwise the reference's
    ``source.py``; its rule registry is the reference's but for ``_load``,
    which imports the port's rule modules."""
    ref = (SRC / "repro/analysis/source.py").read_text(encoding="utf-8")
    port = (PORT / "analysis/source.py").read_text(encoding="utf-8")
    assert "repro-lint" not in ast.dump(_code(port))
    assert ast.dump(_code(port)) == \
        ast.dump(_code(ref.replace("repro-lint", "torch-lint")))

    def registry(text):
        return [ast.dump(n) for n in _code(text).body
                if not (isinstance(n, ast.FunctionDef) and n.name == "_load")]
    assert registry((PORT / "analysis/rules/__init__.py").read_text()) == \
        registry((SRC / "repro/analysis/rules/__init__.py").read_text())


def test_analysis_modules_are_scanned_and_need_no_dependency():
    """The linter's modules are among those the import checks above cover,
    and importing it (package ``__init__`` included) loads neither torch
    nor numpy: it runs before any dependency is importable."""
    mods = _port_modules()
    for m in ("repro_torch.analysis", "repro_torch.analysis.lint",
              "repro_torch.analysis.callgraph",
              "repro_torch.analysis.rules.host_sync",
              "repro_torch.analysis.rules.capture",
              "repro_torch.analysis.rules.staging",
              "repro_torch.analysis.rules.kernel_launch",
              "repro_torch.analysis.rules.config_drift"):
        assert m in mods
    code = ("import sys\n"
            "import repro_torch.analysis.lint\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
