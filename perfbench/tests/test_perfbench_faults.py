"""The check catches a broken timed path: each fault a served model can
have, planted underneath a run of the harness (which skips run.py's look
for a card), turns ``correct`` false."""
import types

import numpy as np
import pytest

from perfbench import harness
from perfbench import program as real
from perfbench.tests import tiny
from perfbench.tests.common import SEED, StepClock


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("bench"))


def broken(fault):
    """The program adapter with ``fault(server)`` applied to its server."""
    P = types.SimpleNamespace(**{k: getattr(real, k) for k in dir(real)
                                 if not k.startswith("__")})

    def server(*a, **kw):
        srv = real.server(*a, **kw)
        fault(srv)
        return srv
    P.server = server
    return P


def altered_token(srv):
    """A served token altered where the decode step produces it."""
    inner, V = srv._decode, srv.cfg.arch.vocab

    def decode(active):
        tok, counts = inner(active)
        tok = np.array(tok)
        tok[active] = (tok[active] + 1) % V
        return tok, counts
    srv._decode = decode


def half_the_batch(srv):
    """Half of the active rows left out of each decode step: their cache
    and position stay, yet they are served a token."""
    inner = srv._decode

    def decode(active):
        act = np.array(active)
        rows = np.flatnonzero(act)
        act[rows[: len(rows) // 2]] = False
        return inner(act)
    srv._decode = decode


def state_unchanged(monkeypatch):
    """Every decode step returns the cache it was given: no new K/V (or
    latent) row is written."""
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "update_rows",
                        lambda buf, upd, pos, active=None: buf)


@pytest.mark.parametrize("cell", ["tiny.qwen3.offload", "tiny.dsv2.offload",
                                  "tiny.qwen3.resident"])
@pytest.mark.parametrize("fault", ["altered_token", "half_the_batch",
                                   "state_unchanged"])
def test_a_planted_fault_is_not_correct(root, cell, fault, monkeypatch):
    if fault == "state_unchanged":
        state_unchanged(monkeypatch)
        P = real
    else:
        P = broken(globals()[fault])
    rec = harness.run(cell, SEED, 1.0, False, "cpu", root=root, P=P,
                      clock=StepClock())
    (value, limit), = rec["check"]["numbers"].values()
    assert rec["check"]["correct"] is False, (value, limit)
    assert value > limit
