"""The port's static invariant checker (``repro_torch.analysis``).

Each of its five rules gets true-positive fixtures (the bad idiom is
flagged) and true-negative ones (the sanctioned idiom is clean). Fixtures
live in strings written to a temp tree, so neither linter's run over
``tests/`` parses them as code or comments. The rule-agnostic cases of
``tests/test_analysis.py`` (suppressions, baseline, CLI) are ported as
cases of parametrized tests. Then: the two linters' directives stay apart,
the port lints clean with an empty baseline, the package imports only the
standard library, and the port's config-drift findings and fences are held
against the reference's.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis.lint import run_lint as ref_run_lint
from repro.analysis.rules.host_sync import \
    DECLARED_FENCES as REF_DECLARED_FENCES
from repro_torch.analysis.baseline import (
    Baseline, BaselineError, TODO_REASON, write_baseline)
from repro_torch.analysis.callgraph import STEP_ENTRIES, CallGraph
from repro_torch.analysis.lint import DEFAULT_BASELINE, run_lint
from repro_torch.analysis.rules.host_sync import (DECLARED_FENCES,
                                                  enclosing_function,
                                                  fence_of, site_verdict)
from repro_torch.analysis.source import ModuleSource, collect_py_files

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "src" / "repro_torch" / "analysis"


def _write(tmp_path, files):
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text), encoding="utf-8")


def _lint(tmp_path, files, select=None, baseline=None):
    _write(tmp_path, files)
    return run_lint([tmp_path], root=tmp_path, baseline=baseline,
                    select=select)


def _hits(res, rule):
    return [f for f in res.new_findings if f.rule == rule]


# ----------------------------------------------------------- host-sync ------
# host-sync scans src/repro_torch (minus the linter and examples/), so
# fixtures sit at that relative path inside the temp root.

SYNC_CASES = {
    "item": ("y = torch.softmax(x, dim=-1)\nreturn y.sum().item()",
             ".item() on device value"),
    "tolist": ("y = torch.topk(x, 2).indices\nreturn y.tolist()",
               ".tolist() on device value"),
    "cpu": ("y = torch.argmax(x, dim=-1)\nreturn y.cpu()",
            ".cpu() on device value"),
    "to_host": ("y = torch.exp(x)\nreturn y.to('cpu')",
                ".to('cpu') of device value"),
    "synchronize": ("torch.cuda.synchronize()\nreturn x",
                    "torch.cuda.synchronize()"),
    "event_synchronize": ("e = torch.cuda.Event()\ne.record()\n"
                          "e.synchronize()\nreturn x", "e.synchronize()"),
    "float": ("y = torch.mean(x)\nreturn float(y)",
              "float() on device value 'y'"),
    "int_of_method_chain": ("y = torch.relu(x).sum(dim=0)\nreturn int(y)",
                            "int() on device value 'y'"),
    "if_test": ("y = torch.isfinite(x).all()\nif y:\n    return x\nreturn y",
                "implicit bool() of device value 'y' in if"),
    "while_test": ("y = torch.ones(2, device=dev)\nwhile y.any():\n"
                   "    y = y - 1\nreturn y", "in while"),
    "assert_test": ("y = torch.zeros(2, device=dev)\nassert (y == 0).all()"
                    "\nreturn y", "in assert"),
    "nonzero": ("y = torch.abs(x)\nreturn y.nonzero()",
                "nonzero() (its output shape depends"),
    "unique": ("y = torch.abs(x)\nreturn torch.unique(y)",
               "unique() (its output shape depends"),
    "bool_mask": ("y = torch.abs(x)\nm = y > 0\nreturn y[m]",
                  "indexing with a boolean mask"),
    "repeat_interleave": ("r = torch.ones(3, dtype=torch.long, device=dev)\n"
                          "y = torch.abs(x)\nreturn y.repeat_interleave(r)",
                          "repeat_interleave() with tensor repeats"),
    "upload_from_numpy": ("return torch.from_numpy(a).to(dev)",
                          "blocking .to(<device>) of host tensor"),
    "upload_tensor": ("return torch.tensor([n, n + 1], device=dev)",
                      "torch.tensor() of host data onto the device"),
    "returned_tensor": ("y = helper(x)\nreturn y.item()",
                        ".item() on device value 'y'"),
    "built_callable": ("f = make()\ny = f(x)\nreturn float(y)",
                       "float() on device value 'y'"),
}

SYNC_PRELUDE = """
import numpy as np
import torch


def helper(x):
    return torch.sigmoid(x)


def make():
    def step(x):
        return torch.tanh(x)
    return step


"""


def _sync_module(body):
    return SYNC_PRELUDE + "def f(x, a, n, dev):\n" + textwrap.indent(
        body, "    ") + "\n"


@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_host_sync_true_positives(tmp_path, case):
    body, want = SYNC_CASES[case]
    res = _lint(tmp_path, {"src/repro_torch/badsync.py": _sync_module(body)},
                select=["host-sync"])
    hits = _hits(res, "host-sync")
    assert len(hits) == 1, [h.message for h in hits]
    assert want in hits[0].message and "outside a declared fence" in \
        hits[0].message, hits[0].message


HOST_SYNC_GOOD = SYNC_PRELUDE + """
def f(x, dev, rows, cfg):
    # a 0-d CPU tensor as a scalar operand: nothing is copied
    y = torch.relu(x) * torch.tensor(cfg.scale, dtype=torch.float32)
    B = y.shape[0]
    n = int(B) + int(y.dim()) + int(y.numel())
    if y is None or "k" in cfg.names:
        return y
    keep = y > 0
    z = torch.where(keep, y, torch.zeros_like(y))
    r = z.repeat_interleave(2, dim=0)
    row = rows[0].to(dev, non_blocking=True)
    host = np.asarray(cfg.table)
    return r, row, n, int(host[0]), float(cfg.lr)
"""


def test_host_sync_true_negatives(tmp_path):
    res = _lint(tmp_path, {"src/repro_torch/oksync.py": HOST_SYNC_GOOD},
                select=["host-sync"])
    assert _hits(res, "host-sync") == []


@pytest.mark.parametrize("rel,code", [
    # a declared fence (serving/slot_runtime.py :: SlotStreamRuntime.decode)
    ("src/repro_torch/serving/slot_runtime.py", """
        import torch

        class SlotStreamRuntime:
            def decode(self, x):
                idx = torch.topk(x, 2).indices
                return idx.cpu().numpy()
    """),
    # examples/ and the linter itself are out of scope, as tests are
    ("src/repro_torch/examples/demo.py", SYNC_PRELUDE + """
    def f(x):
        return torch.sigmoid(x).item()
    """),
    ("src/repro_torch/analysis/x.py", SYNC_PRELUDE + """
    def f(x):
        return torch.sigmoid(x).item()
    """),
    # a step-reachable function's sync belongs to capture-hazard
    ("src/repro_torch/models/model.py", """
        import torch

        class Model:
            def serve_step(self, cache, tok):
                return torch.relu(tok).item()
    """),
], ids=["fence", "examples", "analysis", "step-reachable"])
def test_host_sync_exempt_locations(tmp_path, rel, code):
    res = _lint(tmp_path, {rel: code}, select=["host-sync"])
    assert _hits(res, "host-sync") == []


def test_site_verdict_attributes_a_line_to_its_fence(tmp_path):
    """What chip_smoke.py asks of a sync the card reports: the function
    holding the line, and whether a fence covers it."""
    code = """
        import torch

        class SlotStreamRuntime:
            def decode(self, x):
                idx = torch.topk(x, 2).indices
                return idx.cpu()

            def _slot_args(self, li):
                return li
    """
    _write(tmp_path, {"src/repro_torch/serving/slot_runtime.py": code})
    mods = [ModuleSource(p, tmp_path) for p in collect_py_files([tmp_path])]
    graph = CallGraph(mods)
    rel = "src/repro_torch/serving/slot_runtime.py"
    assert enclosing_function(graph, rel, 7).qualname == \
        "SlotStreamRuntime.decode"
    assert site_verdict(graph, rel, 7).startswith(
        "fence SlotStreamRuntime.decode")
    assert site_verdict(graph, rel, 10) is None
    assert site_verdict(graph, rel, 1) is None


# ------------------------------------------------------- capture-hazard ------

CAPTURE_BAD = """
import torch


class Model:
    def serve_step(self, cache, tok):
        x = self._embed_step(tok)
        n = torch.abs(x).sum().item()
        idx = torch.nonzero(x)
        rows = torch.tensor([1, 2], device=x.device)
        fenced = self.fence(x)
        return x, n, idx, rows, fenced

    def _embed_step(self, tok):
        table = []
        table.append(2)

        def scale(v):
            return v * table[0]
        return scale(torch.relu(tok))

    def fence(self, x):
        return torch.relu(x).cpu()
"""

CAPTURE_GOOD = """
import torch


class Model:
    def serve_step(self, cache, tok):
        x = torch.relu(tok) * torch.tensor(2.0, dtype=torch.float32)
        keep = x > 0
        y = torch.where(keep, x, torch.zeros_like(x))
        z = y.repeat_interleave(4, dim=0)
        B = z.shape[0]
        return z[:B], cache
"""


def test_capture_hazard_true_positives(tmp_path):
    res = _lint(tmp_path, {"src/repro_torch/models/model.py": CAPTURE_BAD},
                select=["capture-hazard"])
    msgs = [f.message for f in _hits(res, "capture-hazard")]
    assert all("Model.serve_step" in m for m in msgs
               if "closure" not in m), msgs
    assert any("host sync" in m and ".item()" in m for m in msgs), msgs
    assert any("data-dependent shape" in m and "nonzero" in m
               for m in msgs), msgs
    assert any("host data copied onto the device" in m for m in msgs), msgs
    assert any("closure variable 'table'" in m for m in msgs), msgs
    assert any("host sync" in m and ".cpu()" in m for m in msgs), msgs


def test_capture_hazard_reports_a_fence_inside_a_step(tmp_path):
    code = """
        import torch

        class SlotStreamRuntime:
            def _route(self, p, h2):
                gates, idx = torch.topk(h2, 2)
                return self.decode(idx)

            def decode(self, idx):
                return torch.relu(idx).cpu()
    """
    res = _lint(tmp_path, {"src/repro_torch/serving/slot_runtime.py": code},
                select=["capture-hazard", "host-sync"])
    hits = _hits(res, "capture-hazard")
    assert len(hits) == 1 and "declared fence SlotStreamRuntime.decode " \
        "inside the capture of SlotStreamRuntime._route" in hits[0].message
    assert _hits(res, "host-sync") == []


def test_capture_hazard_true_negative(tmp_path):
    res = _lint(tmp_path, {"src/repro_torch/models/model.py": CAPTURE_GOOD},
                select=["capture-hazard"])
    assert _hits(res, "capture-hazard") == []


CAPTURE_PARAMS = """
import torch


class Model:
    def serve_step(self, cache, tok, *, decode_window: int = 0, active=None):
        pos = cache["pos"]
        if pos.max() > 4:
            tok = tok + 1
        return check(tok, pos, 2, decode_window, tok.device), tok.item()


def check(x, pos, n: int, window=0, device=None, names=("a",)):
    if window and n > 2 and "a" in names:
        raise ValueError(n)
    if x.device != device or pos.dtype != torch.int32:
        raise ValueError(device)
    return x * int(n) + float(window)
"""


def test_capture_hazard_taints_what_may_be_a_tensor_parameter(tmp_path):
    """A step's inputs are parameters: a method of one is a tensor op
    (``pos.max()``, ``tok.item()``); an int-annotated or constant-default
    parameter, a device or dtype compared, a container method is not."""
    res = _lint(tmp_path, {"src/repro_torch/models/model.py":
                           CAPTURE_PARAMS}, select=["capture-hazard"])
    got = sorted((f.qualname, f.message.split(": ", 1)[1])
                 for f in _hits(res, "capture-hazard"))
    assert got == [
        ("Model.serve_step", ".item() on device value 'tok'"),
        ("Model.serve_step", "implicit bool() of device value "
                             "'pos.max() > 4' in if"),
    ], got


def test_capture_hazard_follows_calls_across_modules(tmp_path):
    files = {
        "src/repro_torch/models/model.py": """
            from repro_torch.kernels import ops
            from repro_torch.models.layers import Norm

            class Model:
                def __init__(self):
                    self.final_norm = Norm()

                def serve_step(self, cache, tok):
                    return ops.attend(self.final_norm(tok))
        """,
        "src/repro_torch/models/layers.py": """
            import torch

            class Norm:
                def forward(self, x):
                    return torch.relu(x).max().item()
        """,
        "src/repro_torch/kernels/ops.py": """
            import torch

            def attend(x):
                return torch.unique(torch.abs(x))
        """}
    res = _lint(tmp_path, files, select=["capture-hazard"])
    where = sorted((f.path.split("/")[-1], f.qualname)
                   for f in _hits(res, "capture-hazard"))
    assert where == [("layers.py", "Norm.forward"), ("ops.py", "attend")]


# -------------------------------------------------------- staging-reuse ------

STAGING_BAD = """
import torch


class Runtime:
    def __init__(self, dev):
        self._rows = torch.zeros((4, 8), dtype=torch.int32,
                                 pin_memory=dev.type == "cuda")

    def rows(self, li, host, dev):
        self._rows[li] = host
        row = self._rows[li].to(dev, non_blocking=True)
        self._rows[li].copy_(host + 1)
        return row

    def view(self, li, host, dev):
        rows = self._rows[li]
        rows[0].copy_(host)
        out = rows.to(dev, non_blocking=True)
        rows.fill_(0)
        return out
"""

STAGING_GOOD = """
import torch


class Runtime:
    def __init__(self, dev):
        self._rows = torch.zeros((4, 8), dtype=torch.int32,
                                 pin_memory=dev.type == "cuda")

    def rows(self, li, host, dev):
        self._rows[li] = host
        row = self._rows[li].to(dev, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        self._rows[li] = host + 1
        return row

    def blocking(self, li, host, dev):
        row = self._rows[li].to(dev)
        self._rows[li] = host
        return row

    def rebound(self, li, host, dev):
        rows = self._rows[li]
        rows[0].copy_(host)
        rows = rows.to(dev, non_blocking=True)
        rows.fill_(0)
        return rows
"""


def test_staging_reuse_true_positives(tmp_path):
    res = _lint(tmp_path, {"src/repro_torch/serving/rt.py": STAGING_BAD},
                select=["staging-reuse"])
    hits = _hits(res, "staging-reuse")
    assert sorted(h.qualname for h in hits) == ["Runtime.rows",
                                                "Runtime.view"], hits
    assert all("page-locked buffer 'self._rows'" in h.message for h in hits)


def test_staging_reuse_true_negatives(tmp_path):
    res = _lint(tmp_path, {"src/repro_torch/serving/rt.py": STAGING_GOOD},
                select=["staging-reuse"])
    assert _hits(res, "staging-reuse") == []


# -------------------------------------------------------- kernel-launch ------

KERNEL_BUILD = """
def load(name):
    return None


def check(name, err):
    if err:
        raise RuntimeError(name)


def check_no_grad(name, *tensors):
    pass
"""

KERNEL_GOOD = """
import torch

from repro_torch.kernels import build

launches = 0


def foo(x):
    global launches
    build.check_no_grad("foo", x)
    y = torch.empty_like(x)
    fn = build.load("foo")
    err = fn(x.data_ptr(), y.data_ptr())
    build.check("foo", err)
    launches += 1
    return y


class Foo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        global launches
        fn = build.load("foo")
        err = fn(x.data_ptr())
        build.check("foo", err)
        launches += 1
        return x
"""

KERNEL_BAD = """
import torch

from repro_torch.kernels import build

launches = 0


def unchecked(x):
    global launches
    build.check_no_grad("foo", x)
    fn = build.load("foo")
    fn(x.data_ptr())
    launches += 1
    return x


def guarded_by_try(x):
    global launches
    build.check_no_grad("foo", x)
    fn = build.load("foo")
    try:
        err = fn(x.data_ptr())
    except OSError:
        err = 0
    build.check("foo", err)
    launches += 1
    return x


def no_grad_check(x):
    global launches
    fn = build.load("foo")
    err = fn(x.data_ptr())
    build.check("foo", err)
    launches += 1
    return x


def uncounted(x):
    build.check_no_grad("foo", x)
    fn = build.load("foo")
    err = fn(x.data_ptr())
    build.check("foo", err)
    return x
"""

KERNEL_OPS = """
from repro_torch.kernels import meta, ref
from repro_torch.kernels.foo import foo


def dispatch(x):
    if x.device.type == "cpu":
        return ref.foo_ref(x)
    if x.device.type == "meta":
        return meta.foo(x)
    return foo(x)


def fallback(x):
    try:
        return foo(x)
    except RuntimeError:
        return ref.foo_ref(x)


def wrong_branch(x):
    if x.device.type == "meta":
        return ref.foo_ref(x)
    return foo(x)
"""


def _kernel_tree(wrappers):
    return {"src/repro_torch/kernels/build.py": KERNEL_BUILD,
            "src/repro_torch/kernels/foo.py": wrappers,
            "src/repro_torch/kernels/ref.py": "def foo_ref(x):\n    "
                                              "return x\n",
            "src/repro_torch/kernels/meta.py": "def foo(x):\n    "
                                               "return x\n",
            "src/repro_torch/kernels/ops.py": KERNEL_OPS}


def test_kernel_launch_true_positives(tmp_path):
    res = _lint(tmp_path, _kernel_tree(KERNEL_BAD), select=["kernel-launch"])
    got = sorted((h.qualname, h.message.split(": ")[0].split(" (")[0])
                 for h in _hits(res, "kernel-launch"))
    assert got == [
        ("fallback", "foo_ref() reached outside a device.type == 'cpu' "
                     "branch"),
        ("guarded_by_try", "launch of kernel 'foo' inside a try"),
        ("no_grad_check", "launch of kernel 'foo' without "
                          "build.check_no_grad on its inputs"),
        ("unchecked", "launch of kernel 'foo' does not pass its error code "
                      "to build.check"),
        ("uncounted", "launch of kernel 'foo' does not bump the module's "
                      "launches counter"),
        ("wrong_branch", "foo_ref() reached outside a device.type == 'cpu' "
                         "branch"),
    ], got


def test_kernel_launch_true_negatives(tmp_path):
    tree = _kernel_tree(KERNEL_GOOD)
    tree["src/repro_torch/kernels/ops.py"] = KERNEL_OPS.split(
        "\n\ndef fallback")[0] + "\n"
    res = _lint(tmp_path, tree, select=["kernel-launch"])
    assert _hits(res, "kernel-launch") == []
    sites = res.graph.to_json()["kernel_launch_sites"]
    assert sorted(s["qualname"] for s in sites) == ["Foo.forward", "foo"]


# --------------------------------------------------------- config-drift ------

R5_BAD = """
    from dataclasses import dataclass

    @dataclass
    class WidgetConfig:
        used_knob: int = 1
        dead_knob: int = 2

    def consume(cfg):
        return cfg.used_knob
"""

R5_PLUMBED = {
    "src/widget.py": """
        from dataclasses import dataclass

        @dataclass
        class EngineConfig:
            n_widgets: int = 4

        def consume(cfg):
            return cfg.n_widgets
    """,
    "src/launch/serve.py": """
        import argparse

        from widget import EngineConfig

        def main():
            ap = argparse.ArgumentParser()
            ap.add_argument("--n-widgets", type=int, default=4)
            args = ap.parse_args()
            return EngineConfig(n_widgets=args.n_widgets)
    """,
}


@pytest.mark.parametrize("files,want", [
    ({"mod.py": R5_BAD}, "WidgetConfig.dead_knob is never read"),
    ({"src/widget.py": R5_PLUMBED["src/widget.py"]},
     "EngineConfig.n_widgets is not settable"),
], ids=["dead-field", "unplumbed-engine-field"])
def test_config_drift_true_positives(tmp_path, files, want):
    res = _lint(tmp_path, files, select=["config-drift"])
    msgs = [f.message for f in _hits(res, "config-drift")]
    assert len(msgs) == 1 and want in msgs[0], msgs


def test_config_drift_plumbed_field_is_clean(tmp_path):
    res = _lint(tmp_path, R5_PLUMBED, select=["config-drift"])
    assert _hits(res, "config-drift") == []


# ------------------------------------------------------- suppressions -------

STAGING_LINE = "        self._rows[li].copy_(host + 1)"


@pytest.mark.parametrize("form", ["inline", "standalone", "all"])
def test_suppression_absorbs_finding(tmp_path, form):
    reason = "fixture: the copy was waited for by the caller"
    if form == "inline":
        text = STAGING_BAD.replace(
            STAGING_LINE, STAGING_LINE + "  # torch-lint: disable="
            f"staging-reuse -- {reason}")
    else:
        rules = "staging-reuse,host-sync" if form == "standalone" else "all"
        text = STAGING_BAD.replace(
            STAGING_LINE, f"        # torch-lint: disable={rules} -- "
            f"{reason}\n" + STAGING_LINE)
    res = _lint(tmp_path, {"src/repro_torch/serving/rt.py": text},
                select=["staging-reuse"])
    assert [h.qualname for h in res.new_findings] == ["Runtime.view"]
    assert len(res.suppressed) == 1
    assert res.suppressed[0]["reason"] == reason


@pytest.mark.parametrize("case", ["no-reason", "unknown-rule", "in-string",
                                  "parse-error", "unused", "malformed"])
def test_directive_meta_cases(tmp_path, case):
    texts = {
        "no-reason": "x = 1  # torch-lint: disable=host-sync\n",
        "unknown-rule": "x = 1  # torch-lint: disable=no-such-rule -- "
                        "because\n",
        "in-string": 'DOC = """\nexample:  # torch-lint: disable=host-sync'
                     '\n"""\n',
        "parse-error": "def f(:\n    pass\n",
        "unused": "x = 1  # torch-lint: disable=host-sync -- nothing here "
                  "syncs\n",
        "malformed": "x = 1  # torch-lint: enable\n",
    }
    res = _lint(tmp_path, {"mod.py": texts[case]})
    rules = [f.rule for f in res.new_findings]
    if case == "no-reason":
        assert rules == ["suppression"]
        assert "without a reason" in res.new_findings[0].message
    elif case == "unknown-rule":
        assert rules == ["suppression"]
        assert "unknown rule(s): no-such-rule" in res.new_findings[0].message
    elif case == "in-string":
        m = ModuleSource(tmp_path / "mod.py", tmp_path)
        assert m.suppressions == [] and m.suppression_findings == []
        assert rules == []
    elif case == "parse-error":
        assert rules == ["parse-error"] and res.exit_code == 1
    elif case == "unused":
        assert rules == []
        assert any("unused suppression" in w for w in res.warnings)
    else:
        assert rules == ["suppression"]
        assert "malformed torch-lint directive" in \
            res.new_findings[0].message


@pytest.mark.parametrize("directive", ["repro-lint", "torch-lint"])
def test_each_linter_reads_only_its_own_directives(tmp_path, directive):
    """A ``repro-lint`` directive means nothing to the port's linter and a
    ``torch-lint`` one nothing to the reference's: neither suppresses the
    other's finding, neither is a malformed or unknown-rule finding, and
    neither is reported unused by the linter it is not meant for."""
    code = STAGING_BAD.replace(
        STAGING_LINE, f"        # {directive}: disable=staging-reuse,"
        "no-such-rule -- fixture\n" + STAGING_LINE)
    _write(tmp_path, {"src/repro_torch/serving/rt.py": code})
    port = run_lint([tmp_path], root=tmp_path)
    ref = ref_run_lint([tmp_path], root=tmp_path)
    mine, other = (port, ref) if directive == "torch-lint" else (ref, port)
    assert [f.rule for f in other.new_findings
            if f.rule == "suppression"] == []
    assert not any("unused suppression" in w for w in other.warnings)
    assert [f.rule for f in mine.new_findings
            if f.rule == "suppression"] == ["suppression"]
    staging = [f for f in port.new_findings if f.rule == "staging-reuse"]
    assert len(staging) == (1 if directive == "torch-lint" else 2)


# ------------------------------------------------------------ baseline ------


def test_baseline_round_trip(tmp_path):
    files = {"src/repro_torch/serving/rt.py": STAGING_BAD}
    res = _lint(tmp_path, files, select=["staging-reuse"])
    assert len(res.new_findings) == 2
    bpath = tmp_path / "b.json"
    write_baseline(bpath, res.new_findings)
    # a freshly written baseline carries TODO reasons, which the loader
    # rejects
    with pytest.raises(BaselineError, match="no real reason"):
        Baseline.load(bpath)
    doc = json.loads(bpath.read_text())
    assert {e["reason"] for e in doc["entries"]} == {TODO_REASON}
    for e in doc["entries"]:
        e["reason"] = "fixture: sanctioned reuse"
    bpath.write_text(json.dumps(doc))
    res2 = _lint(tmp_path, {}, select=["staging-reuse"],
                 baseline=Baseline.load(bpath))
    assert res2.new_findings == [] and len(res2.baselined) == 2
    assert res2.exit_code == 0
    # rewritten with the old one: the reasons carry over
    doc2 = write_baseline(bpath, res.new_findings, old=Baseline.load(bpath))
    assert {e["reason"] for e in doc2["entries"]} == \
        {"fixture: sanctioned reuse"}


@pytest.mark.parametrize("case", ["missing-fields", "stale", "todo"])
def test_baseline_rejects_and_warns(tmp_path, case):
    entry = {"rule": "host-sync", "path": "gone.py", "code": "x",
             "message": "no longer fires", "count": 1,
             "reason": "fixture: entry for a deleted file"}
    if case == "missing-fields":
        with pytest.raises(BaselineError, match="missing fields"):
            Baseline([{"rule": "host-sync", "path": "x.py"}])
    elif case == "todo":
        with pytest.raises(BaselineError, match="no real reason"):
            Baseline([dict(entry, reason=TODO_REASON)])
    else:
        res = _lint(tmp_path, {"mod.py": "x = 1\n"},
                    baseline=Baseline([entry]))
        assert any("stale baseline entry" in w for w in res.warnings)


# --------------------------------------------------------- capture map ------


def test_capture_map_artifact_shape(tmp_path):
    tree = _kernel_tree(KERNEL_GOOD)
    tree["src/repro_torch/models/model.py"] = CAPTURE_GOOD
    res = _lint(tmp_path, tree)
    doc = res.graph.to_json()
    entries = {e["qualname"]: e for e in doc["step_entries"]}
    assert set(entries) == {q for _, q, _ in STEP_ENTRIES}
    assert entries["Model.serve_step"]["line"] == 6
    assert entries["Model.prefill"]["line"] is None      # not in this tree
    assert doc["step_reachable"][
        "src/repro_torch/models/model.py::Model.serve_step"]["from"] == \
        ["Model.serve_step"]
    assert doc["autograd_functions"] == {
        "src/repro_torch/kernels/foo.py::Foo": ["forward"]}


# ----------------------------------------------------------------- CLI ------


def _run_cli(args, cwd):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("case", ["json", "select", "missing-baseline",
                                  "list-rules", "capture-map"])
def test_cli(tmp_path, case):
    bad = tmp_path / "tree"
    _write(bad, {"src/repro_torch/serving/rt.py": STAGING_BAD})
    if case == "json":
        report = tmp_path / "report.json"
        proc = _run_cli(["--no-baseline", "--json", str(report), str(bad)],
                        cwd=bad)
        assert proc.returncode == 1, proc.stdout + proc.stderr
        doc = json.loads(report.read_text())
        assert doc["summary"]["new"] == 2
        assert doc["summary"]["declared_fences"] == len(DECLARED_FENCES)
        assert {f["rule"] for f in doc["findings"]} == {"staging-reuse"}
    elif case == "select":
        proc = _run_cli(["--no-baseline", "--select", "host-sync",
                         str(bad)], cwd=bad)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    elif case == "missing-baseline":
        proc = _run_cli(["--baseline", str(tmp_path / "missing.json"),
                         str(bad)], cwd=bad)
        assert proc.returncode == 2
    elif case == "list-rules":
        proc = _run_cli(["--list-rules"], cwd=tmp_path)
        assert proc.returncode == 0
        assert [ln.split(":")[0] for ln in proc.stdout.splitlines()] == \
            ["capture-hazard", "config-drift", "host-sync", "kernel-launch",
             "staging-reuse"]
    else:
        cmap = tmp_path / "capture.json"
        proc = _run_cli(["--no-baseline", "--capture-map", str(cmap),
                         str(bad)], cwd=bad)
        assert proc.returncode == 1
        doc = json.loads(cmap.read_text())
        assert set(doc) == {"step_entries", "step_reachable",
                            "kernel_launch_sites", "autograd_functions"}


# ---------------------------------------------------------- self-check ------


def test_port_lints_clean_with_no_baseline_entries(monkeypatch):
    """``src/repro_torch`` lints clean: every sanctioned finding is a
    declared fence or step entry, or a ``torch-lint`` directive with its
    reason; the committed baseline has no entries."""
    # paths relative to the repo root, as the CLI's default: the linter
    # skips a file with a hidden directory anywhere in its path, so an
    # absolute one would depend on where the checkout lives
    monkeypatch.chdir(REPO)
    doc = json.loads((REPO / DEFAULT_BASELINE).read_text())
    assert doc["entries"] == []
    res = run_lint([Path("src/repro_torch")], root=REPO,
                   baseline=Baseline.load(REPO / DEFAULT_BASELINE))
    assert res.n_files == len(list((REPO / "src/repro_torch").rglob("*.py")))
    assert res.new_findings == [], \
        "\n".join(f.format() for f in res.new_findings)
    assert res.exit_code == 0 and res.baselined == []
    assert not any("unused suppression" in w for w in res.warnings), \
        res.warnings
    # every step entry names a real function of the port
    assert all(fi is not None for *_, fi in res.graph.entries), \
        [q for _, q, _, fi in res.graph.entries if fi is None]


def test_analysis_package_is_stdlib_only():
    stdlib = set(sys.stdlib_module_names)
    for p in sorted(PKG.rglob("*.py")):
        tree = ast.parse(p.read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] in stdlib or \
                    mod == "repro_torch.analysis" or \
                    mod.startswith("repro_torch.analysis."), \
                    f"{p.name}: imports {mod!r}"


def test_linter_loads_no_third_party_modules():
    code = (
        "import sys\n"
        "import repro_torch.analysis.lint\n"
        "from repro_torch.analysis.rules import all_rules\n"
        "assert len(all_rules()) == 5\n"
        "heavy = ('torch', 'numpy', 'jax', 'jaxlib', 'scipy', 'triton')\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules\n"
        "              if m.split('.')[0] in heavy})\n"
        "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


# ------------------------------------------------- parity with reference ----


def _drift_keys(findings):
    out = set()
    for f in findings:
        if f["rule"] != "config-drift":
            continue
        cls_field = f["message"].split(" ")[0]
        kind = "unread" if "never read" in f["message"] else "unplumbed"
        out.add((*cls_field.split("."), kind))
    return out


def test_config_drift_matches_the_reference(monkeypatch):
    """The reference's config-drift over ``src/repro`` and
    ``benchmarks/common.py`` (the trace-mode harness the port copies into
    ``serving/harness.py``, whose ``build_engine`` sets the ServeSpec,
    PredictorSpec and EngineConfig fields) with no baseline, and the
    port's over ``src/repro_torch`` with its directives ignored, give the
    same (dataclass, field, kind) set: the port copies every config
    dataclass and has no extra finding in its own. The set is the six
    entries of the reference's ``analysis-baseline.json``."""
    monkeypatch.chdir(REPO)
    ref = ref_run_lint([Path("src/repro"), Path("benchmarks/common.py")],
                       root=REPO, select=["config-drift"])
    port = run_lint([Path("src/repro_torch")], root=REPO,
                    select=["config-drift"])
    assert ref.n_files > 0 and port.n_files > 0
    ref_keys = _drift_keys([f.to_json() for f in ref.new_findings])
    port_keys = _drift_keys([f.to_json() for f in port.new_findings]
                            + port.suppressed)
    assert port.new_findings == []
    extra_in_port = set()        # none: name each one here if that changes
    assert port_keys == ref_keys | extra_in_port
    baseline = json.loads((REPO / "analysis-baseline.json").read_text())
    assert _drift_keys(baseline["entries"]) == ref_keys
    assert len(baseline["entries"]) == 6


def test_every_reference_fence_maps_to_a_real_port_fence(monkeypatch):
    monkeypatch.chdir(REPO)
    mods = [ModuleSource(p, REPO) for p in
            collect_py_files([Path("src/repro_torch")])]
    graph = CallGraph(mods)
    maps_to = {}
    for suffix, qual, ref_fence, reason in DECLARED_FENCES:
        fi = graph.find_function(suffix, qual)
        assert fi is not None, f"{suffix}::{qual} is not a port function"
        assert fence_of(fi.module, fi)[1] == qual
        assert reason.strip()
        maps_to.setdefault(ref_fence, []).append(qual)
    for suffix, qual, _reason in REF_DECLARED_FENCES:
        assert f"{suffix}::{qual}" in maps_to, (suffix, qual)
    assert set(maps_to) == {f"{s}::{q}" for s, q, _ in REF_DECLARED_FENCES}
