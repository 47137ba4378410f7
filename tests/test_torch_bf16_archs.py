"""Forward, padded prefill and four gated pooled decode steps in bf16,
held against the reference by ``test_torch_bf16.py``'s criterion, for
the next five architectures of ``ALL_ARCHS`` (two Switch
sizes, NLLB-MoE, DeepSeek-V2's MLA, Gemma-2's windows and softcaps)."""
import pytest
import torch

from test_torch_bf16 import ALL_ARCHS, Trio, run_decode, run_forward, \
    run_prefill

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=ALL_ARCHS[5:10])
def trio(request):
    return Trio(request.param)


def test_forward_within_bf16_criterion(trio):
    run_forward(trio)


def test_padded_prefill_within_bf16_criterion(trio):
    run_prefill(trio)


def test_teacher_forced_decode_within_bf16_criterion(trio):
    run_decode(trio)
