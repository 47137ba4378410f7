"""The paper's serving features through the port's launcher against the
reference's, on the same weights (reduced qwen3-moe, the reference's
``PRNGKey(0)`` weights loaded through ``from_reference``): the SSD -> DRAM
-> GPU tiers, the online EAMC with the hybrid predictor and drift
recording, the learned predictor, two tenants with private predictors,
and the cold -> warm restarts of ``--eamc-path``, ``--predictor-path`` and
the tenants' files. Every report line is equal but the wall-clock ones
(``compiles=``, ``demand-stall=``); temp paths read ``<tmp>``. The
card's run of the same flags is ``chip_smoke.py`` phase 15."""
import contextlib
import copy
import io
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import serve as jax_serve
from repro.models import Model as JaxModel
from repro_torch.configs import get_config as torch_get_config
from repro_torch.launch import serve as torch_serve
from repro_torch.models import Model
from repro_torch.params import from_reference

torch.set_num_threads(2)

ARCH = "qwen3-moe-235b-a22b"
BASE = ["--arch", ARCH, "--reduced", "--requests", "3", "--seed", "3"]
KEEP = ("req ", "total:", "tiers:", "slots:", "eamc:", "predictor:",
        "tenant ")


@pytest.fixture(scope="module")
def model():
    params = JaxModel(get_config(ARCH).reduced()).init(jax.random.PRNGKey(0))
    return from_reference(Model(torch_get_config(ARCH).reduced(),
                                device="cpu"),
                          jax.tree.map(np.asarray, params))


def _report(fn, tmp):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    out = []
    for line in buf.getvalue().splitlines():
        if line.startswith(KEEP):
            line = re.sub(r", compiles=.*$", "", line)
            line = re.sub(r"demand-stall=\S+ \(\S+\) ", "", line)
            out.append(line.replace(str(tmp), "<tmp>"))
    return out


def _both(model, flags, ref_dir, port_dir):
    """-> (reference lines, port lines); ``{dir}`` in a flag reads each
    launcher's own directory, so that each keeps its own files."""
    want = _report(lambda: jax_serve.main(
        [f.format(dir=ref_dir) for f in flags]), ref_dir)
    cfg = torch_get_config(ARCH).reduced()
    args = torch_serve.parse_args([f.format(dir=port_dir) for f in flags]
                                  + ["--device", "cpu"])
    got = _report(lambda: torch_serve.serve(args, cfg, copy.deepcopy(model)),
                  port_dir)
    return want, got


def _line(lines, prefix):
    return next(ln for ln in lines if ln.startswith(prefix))


def _toks(lines):
    return re.findall(r"toks=([\d,]+)", "\n".join(lines))


FEATURES = {
    "ssd-all-resident": ["--ssd-gbps", "3.5", "--dram-cache", "6"],
    "ssd-rf05-int8": ["--ssd-gbps", "3.5", "--dram-cache", "6",
                      "--resident-fraction", "0.5", "--transfer-dtype",
                      "int8"],
    "online-hybrid-drift": ["--eamc-online", "--predictor", "hybrid",
                            "--record-drift"],
    "learned": ["--predictor", "learned"],
}


@pytest.mark.parametrize("feature", FEATURES)
def test_feature_report_matches_reference(model, tmp_path, feature):
    want, got = _both(model, BASE + FEATURES[feature], tmp_path / "ref",
                      tmp_path / "port")
    assert len(want) == 3 + 5
    assert got == want
    if feature.startswith("ssd"):
        ssd = re.search(r"tiers: demand dram=\d+ ssd=(\d+)",
                        _line(got, "tiers:"))
        assert int(ssd.group(1)) > 0, "no SSD demand fetch"
    if feature == "ssd-rf05-int8":
        assert _line(got, "slots:").startswith("slots: resident=4/8 ")
    if feature == "online-hybrid-drift":
        assert _line(got, "eamc:").startswith("eamc: source=cold ")
        assert _line(got, "predictor:").startswith(
            "predictor: kind=hybrid source=cold ")
    if feature == "learned":
        assert _line(got, "predictor:").startswith(
            "predictor: kind=learned source=cold ")


def _tenants_file(path, home):
    # scripts/ci.sh's two tenants: private online EAMC brains persisted
    # under ``home``, an interactive tenant with a slot quota and a batch
    # tenant with a stall budget
    path.write_text(json.dumps([
        {"tenant_id": "acme", "sla_class": "interactive",
         "predictor": {"kind": "eamc", "online": True,
                       "path": str(home / "acme")},
         "gpu_slot_quota": 3, "rps": 2.0},
        {"tenant_id": "globex", "sla_class": "batch", "stall_budget": 2,
         "predictor": {"kind": "eamc", "online": True,
                       "path": str(home / "globex")},
         "rps": 1.0}]))
    return path


# scripts/ci.sh's SMOKE restarts, flag for flag, on the reference's weights
CI = ["--arch", ARCH, "--reduced"]
RESTARTS = {
    "eamc-path": CI + ["--requests", "4", "--eamc-online", "--eamc-path",
                       "{dir}/eamc"],
    "predictor-path": CI + ["--requests", "4", "--predictor", "learned",
                            "--predictor-path", "{dir}/pred"],
    "tenants": CI + ["--requests", "6", "--tenants", "{dir}/tenants.json"],
}


@pytest.mark.parametrize("what", RESTARTS)
def test_cold_then_warm_restart_matches_reference(model, tmp_path, what):
    """A cold run persists its brain; the second run with the same flags
    loads it (``source=load``) and serves the same tokens; both launchers
    print the same lines at each step. These are ci.sh's weights, so ci.sh's
    checks hold here too, the EAMC's warm hit ratio at least the cold one's
    among them (``scripts/ci_torch.sh`` serves the port's own weights,
    where that ratio is a property of other weights)."""
    dirs = tmp_path / "ref", tmp_path / "port"
    for d in dirs:
        d.mkdir()
        _tenants_file(d / "tenants.json", d)
    runs = [_both(model, RESTARTS[what], *dirs) for _ in ("cold", "warm")]
    for want, got in runs:
        assert got == want
    cold, warm = (got for _, got in runs)
    assert _toks(cold) and _toks(cold) == _toks(warm)
    if what == "eamc-path":
        assert _line(cold, "eamc: source=").startswith("eamc: source=cold ")
        assert _line(warm, "eamc: source=").startswith("eamc: source=load ")
        assert "eamc: saved " in "\n".join(warm)
        hit = [float(re.search(r"hit=([0-9.]+)", _line(r, "total:"))
                     .group(1)) for r in (cold, warm)]
        assert hit[1] >= hit[0]
    elif what == "predictor-path":
        assert " source=cold " in _line(cold, "predictor: kind=")
        assert " source=load " in _line(warm, "predictor: kind=")
        saved = [int(re.search(r"saved seqs=(\d+)", "\n".join(r)).group(1))
                 for r in (cold, warm)]
        assert 0 < saved[0] < saved[1]
    else:
        for lines, src in ((cold, "cold"), (warm, "load")):
            got = dict(re.findall(r"tenant (\w+): sla=.* src=(\w+)",
                                  "\n".join(lines)))
            assert got == {"acme": src, "globex": src}
        saved = re.findall(r"tenant \w+: saved predictor -> (\S+)",
                           "\n".join(warm))
        assert sorted(saved) == ["<tmp>/acme.npz", "<tmp>/globex.npz"]
        assert all((dirs[1] / n).exists() for n in ("acme.npz",
                                                    "globex.npz"))


def test_launcher_refuses_a_cut_with_no_moe_layer():
    """Reduced nllb-moe-128 keeps 2 layers, and its MoE layers sit every 4
    from layer 3: the cut has none. The port refuses it by name before
    building anything (the reference fails later, on an empty layer
    list)."""
    cfg = torch_get_config("nllb-moe-128").reduced()
    assert not any(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    args = torch_serve.parse_args(["--arch", "nllb-moe-128", "--reduced",
                                   "--device", "cpu"])
    with pytest.raises(SystemExit, match="has no MoE layer"):
        torch_serve.serve(args, cfg)
    with pytest.raises(SystemExit, match="has no MoE layer"):
        torch_serve.main(["--arch", "nllb-moe-128", "--reduced", "--device",
                          "cpu"])
