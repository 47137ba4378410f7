"""Model-mode serving on the port (TorchModelServer and the port's
launcher) against the reference (JaxModelServer and repro.launch.serve) on
the CPU, with the reference's weights: the same tokens, the same EAM-driven
offload decisions, the same report lines."""
import contextlib
import io
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import serve as jax_serve
from repro.models import Model as JaxModel
from repro.serving import EngineConfig, SchedulerConfig
from repro.serving.engine import JaxModelServer
from repro.serving.request import Request
from repro_torch.configs import get_config as torch_get_config
from repro_torch.launch import serve as torch_serve
from repro_torch.models import Model
from repro_torch.params import from_reference
from repro_torch.serving import EngineConfig as TorchEngineConfig
from repro_torch.serving import SchedulerConfig as TorchSchedulerConfig
from repro_torch.serving import TorchModelServer
from repro_torch.serving.request import Request as TorchRequest

torch.set_num_threads(2)

ARCH = "qwen3-moe-235b-a22b"


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(get_config(ARCH).reduced())
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model(torch_get_config(ARCH).reduced(), device="cpu")
    from_reference(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _requests(cls, vocab):
    """Ragged prompts and budgets, staggered arrivals (5 requests through
    4 slots: one waits for a slot to recycle)."""
    out = []
    for rid, (plen, budget, t) in enumerate([(5, 6, 0.0), (9, 4, 0.0),
                                             (3, 7, 1e-4), (12, 3, 2e-4),
                                             (6, 5, 3e-4)]):
        rng = np.random.default_rng(100 + rid)
        out.append(cls(rid=rid, arrival=t, max_new_tokens=budget,
                       prompt=rng.integers(0, vocab, plen).astype(np.int32)))
    return out


def test_torch_server_matches_jax_server(models):
    jm, params, tm = models

    def cfg(ec, sc, arch):
        return ec(arch=arch, gpu_cache_experts=3, dram_cache_experts=6,
                  scheduler=sc(max_batch=4))

    jsrv = JaxModelServer(cfg(EngineConfig, SchedulerConfig, jm.cfg), jm,
                          params, cache_len=32)
    tsrv = TorchModelServer(cfg(TorchEngineConfig, TorchSchedulerConfig,
                                tm.cfg), tm, cache_len=32, device="cpu")
    for r in _requests(Request, jm.cfg.vocab):
        jsrv.submit(r)
    for r in _requests(TorchRequest, tm.cfg.vocab):
        tsrv.submit(r)
    jsrv.drain()
    tsrv.drain()
    assert tsrv.generated == jsrv.generated
    assert all(len(tsrv.generated[r]) == b
               for r, b in enumerate([6, 4, 7, 3, 5]))
    assert tsrv.compile_counts == {}
    js, ts = jsrv.stats(), tsrv.stats()
    assert ts.keys() == js.keys()
    assert ts["demand_fetches"] > 0
    # every offload counter (hits, demand fetches by tier, staged
    # prefetches, link bytes) and the virtual clock: identical
    np.testing.assert_equal(ts, js)
    for rid in jsrv.request_eams:
        np.testing.assert_array_equal(tsrv.request_eams[rid],
                                      jsrv.request_eams[rid])
    # one pooled decode step per iteration with a decoder, one B=1 prefill
    # per request
    assert tsrv.n_prefills == 5


def _report(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    keep = ("req ", "total:", "tiers:", "eamc:", "predictor:")
    return [re.sub(r", compiles=.*$", "", line)
            for line in buf.getvalue().splitlines() if line.startswith(keep)]


def test_launcher_report_lines_match_reference(models):
    _, params, _ = models
    flags = ["--arch", ARCH, "--reduced", "--requests", "3", "--seed", "3"]
    want = _report(lambda: jax_serve.main(flags))
    cfg = torch_get_config(ARCH).reduced()
    model = from_reference(Model(cfg, device="cpu"),
                           jax.tree.map(np.asarray, params))
    args = torch_serve.parse_args(flags + ["--device", "cpu"])
    got = _report(lambda: torch_serve.serve(args, cfg, model))
    assert len(want) == 3 + 4
    assert got == want

