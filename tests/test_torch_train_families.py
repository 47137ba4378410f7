"""Loss and every gradient of each model family on the port against
``jax.value_and_grad(model.loss)`` on the CPU in fp32: Gemma-2 (windows,
softcaps), Whisper (encoder, cross-attention), Qwen2-VL (M-RoPE over
embeddings), Jamba (Mamba + MoE), RWKV6, Switch (top-1 MoE), NLLB-MoE
(encoder-decoder), Nemotron-4 (relu2, LayerNorm) and Qwen2 (qkv bias),
each plain, remat-full and
remat-dots at a dropping capacity (the cases of
``test_torch_train.py::test_loss_and_every_gradient_match_reference``,
which holds the MoE decoders)."""
import pytest
import torch

from test_torch_train import LOSS_CASES, LOSS_IDS, \
    check_loss_and_every_gradient

torch.set_num_threads(2)

FAMILIES = ["gemma2-2b", "whisper-small", "qwen2-vl-72b",
            "jamba-1.5-large-398b", "rwkv6-7b", "switch-base-128",
            "nllb-moe-128", "nemotron-4-15b", "qwen2-1.5b"]


@pytest.mark.parametrize("remat,policy,cf,labels", LOSS_CASES, ids=LOSS_IDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_and_every_gradient_match_reference(arch, remat, policy,
                                                        cf, labels):
    check_loss_and_every_gradient(arch, remat, policy, cf, labels)
