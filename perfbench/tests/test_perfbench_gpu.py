"""On the card: each listed cell, at its own size and a short window,
serves correctly, and its control (the reference in fp8 in the
program's place) does not. Run there with

    python -m pytest -m gpu perfbench/tests/test_perfbench_gpu.py
"""
import json

import pytest

from perfbench.tests.common import REPO, SEED

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at full width")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_and_its_control_is_not(card, cell):
    from perfbench import harness
    rec = harness.run(cell, SEED, 50.0, False, card, control=True)
    check = rec["check"]
    assert check["correct"]
    ctrl = check["stats"]["control"]
    ctrl = {"logit_gap": ctrl["max"], "logit_gap_mean": ctrl["mean"]}
    assert any(ctrl[k] > lim for k, (_, lim) in check["numbers"].items())
