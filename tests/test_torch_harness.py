"""The port's trace-mode harness (``repro_torch.serving.harness``, a copy
of ``benchmarks/common.py``) and its ``serve_trace.py`` against the
reference's: the same engines from the same specs give the same
``stats()``, and the example prints the reference's table line for line.
Trace mode runs no model, so nothing here touches a device."""
import contextlib
import io
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import common as ref_common
from repro.serving.spec import PredictorSpec as RefPredictorSpec
from repro.serving.spec import ServeSpec as RefServeSpec
from repro.serving.spec import TenantSpec as RefTenantSpec
from repro_torch.examples import serve_trace
from repro_torch.serving import harness
from repro_torch.serving.spec import PredictorSpec, ServeSpec, TenantSpec

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ARCH = "switch-base-128"
N_REQUESTS = 8


def _same(a, b, where="stats"):
    """Equal values, NaN equal to NaN, through dicts, lists and arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), where
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def _run(mod, engine, n=N_REQUESTS):
    reqs = mod.run_workload(engine, n_requests=n, rps=2.0, seed=3)
    return engine.stats(), [(r.rid, r.latency, r.per_token_latency)
                            for r in reqs]


@pytest.mark.parametrize("system", list(ref_common.SYSTEMS))
def test_each_system_matches_the_reference(system):
    """``build_engine(arch, system)`` (the legacy kwargs the example uses)
    over one oracle and offline EAMC per package."""
    assert harness.SYSTEMS == ref_common.SYSTEMS
    got, want = [], []
    for mod, out in ((harness, got), (ref_common, want)):
        arch = mod.get_config(ARCH)
        oracle = mod.build_oracle(arch)
        eamc = mod.build_eamc(arch, oracle)
        eng = mod.build_engine(ARCH, system, eamc=eamc, oracle=oracle)
        out.extend(_run(mod, eng))
    _same(got[0], want[0])
    assert got[1] == want[1]


def _specs(pkg):
    """The same ServeSpec in each package: (label, spec)."""
    S, P, T = ((ServeSpec, PredictorSpec, TenantSpec) if pkg == "port" else
               (RefServeSpec, RefPredictorSpec, RefTenantSpec))
    tenants = (T(tenant_id="acme", sla_class="interactive",
                 predictor=P(kind="eamc", online=True), gpu_slot_quota=40,
                 rps=2.0),
               T(tenant_id="globex", sla_class="batch", stall_budget=2,
                 predictor=P(kind="learned", online=True), rps=1.0))
    return [
        ("ssd-three-tier", S(arch=ARCH, ssd_gbps=3.5, dram_slots=150)),
        ("online-eamc", S(arch=ARCH, predictor=P(online=True))),
        ("learned", S(arch=ARCH, predictor=P(kind="learned", online=True))),
        ("rf0.5-int8-D2", S(arch=ARCH, resident_fraction=0.5,
                            transfer_dtype="int8", n_devices=2)),
        ("static-stall", S(arch=ARCH, scheduling="static", policy="stall",
                           max_batch=4)),
        ("two-tenants", S(arch=ARCH, policy="stall", tenants=tenants)),
    ]


@pytest.mark.parametrize("i", range(len(_specs("port"))),
                         ids=[label for label, _ in _specs("port")])
def test_spec_engines_match_the_reference(i):
    """``build_engine(ServeSpec)`` over the tiers, the EAMC lifecycle, the
    learned brain, the slot mirror and expert parallelism, the static
    scheduler, and tenants."""
    (_, port_spec), (_, ref_spec) = _specs("port")[i], _specs("ref")[i]
    assert port_spec.to_dict() == ref_spec.to_dict()
    got = _run(harness, harness.build_engine(port_spec))
    want = _run(ref_common, ref_common.build_engine(ref_spec))
    _same(got[0], want[0])
    assert got[1] == want[1]


def test_scenario_runner_matches_the_reference():
    """The cold-start replay over every lifecycle variant (offline peek,
    online, no EAMC) carried across two phases on one engine."""
    kw = dict(n_per_phase=4, dram_slots=150)
    got = harness.run_lifecycle_scenario("coldstart", **kw)
    want = ref_common.run_lifecycle_scenario("coldstart", **kw)
    assert list(got) == list(want) == list(harness.LIFECYCLE_VARIANTS)
    _same(got, want, "scenario")


def test_serve_trace_prints_the_reference_table():
    """``python -m repro_torch.examples.serve_trace`` against
    ``examples/serve_trace.py`` with the same flags: every system, 12
    requests, line for line."""
    flags = ["--requests", "12"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO)]), JAX_PLATFORMS="cpu")
    ref = subprocess.run(
        [sys.executable, str(REPO / "examples/serve_trace.py"), *flags],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert ref.returncode == 0, ref.stderr
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_trace.main(flags)
    want = ref.stdout.splitlines()
    assert len(want) == 1 + len(harness.SYSTEMS)
    assert buf.getvalue().splitlines() == want
