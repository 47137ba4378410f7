"""The port's CUDA kernels and its model on the card, against their plain
PyTorch versions and the CPU. Every test needs an NVIDIA GPU with nvcc and
skips without one; this file imports no JAX, so it runs where the port
runs:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_decode as fd_mod
from repro_torch.kernels import moe_ffn as moe_mod
from repro_torch.kernels import ref
from repro_torch.models import Model
from repro_torch.serving import EngineConfig, TorchModelServer

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype: str):
    # as tests/test_kernels.py: fp32 sums in another order; bf16 rounds the
    # hidden activation and the output
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, std, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, np.float32) * std) \
        .to(dev, DTYPES[dtype])


def _f32(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_moe_ffn_kernel_matches_plain(cuda, dtype, act):
    rng = np.random.default_rng(5)
    E, C, d, f = 3, 13, 520, 700          # no tile divides C, d or f
    xg = _rand(rng, (E, C, d), 1.0, dtype, cuda)
    wg = (_rand(rng, (E, d, f), d ** -0.5, dtype, cuda)
          if act in ("swiglu", "geglu") else None)
    wu = _rand(rng, (E, d, f), d ** -0.5, dtype, cuda)
    wd = _rand(rng, (E, f, d), f ** -0.5, dtype, cuda)
    before = moe_mod.launches
    y = moe_mod.moe_ffn(xg, wg, wu, wd, act=act)
    assert moe_mod.launches == before + 1
    np.testing.assert_allclose(_f32(y), _f32(ref.moe_ffn_ref(
        xg, wg, wu, wd, act=act)), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_matches_plain(cuda, dtype):
    """Per-slot lengths, including a full cache, one position and none
    (the reference's softmax over all-masked scores is uniform)."""
    rng = np.random.default_rng(4)
    q = _rand(rng, (4, 16, 64), 1.0, dtype, cuda)
    k = _rand(rng, (4, 300, 4, 64), 1.0, dtype, cuda)
    v = _rand(rng, (4, 300, 4, 64), 1.0, dtype, cuda)
    lens = torch.tensor([300, 1, 0, 299], dtype=torch.int32, device=cuda)
    before = fd_mod.launches
    y = fd_mod.flash_decode(q, k, v, lens)
    assert fd_mod.launches == before + 1
    np.testing.assert_allclose(_f32(y), _f32(ref.flash_decode_ref(
        q, k, v, lens)), **_tol(dtype))


def test_kernel_wrappers_validate_inputs(cuda):
    x = torch.zeros(2, 4, 8, device=cuda)
    w = torch.zeros(2, 8, 16, device=cuda)
    wd = torch.zeros(2, 16, 8, device=cuda)
    with pytest.raises(TypeError):
        moe_mod.moe_ffn(x.half(), w.half(), w.half(), wd.half())
    with pytest.raises(ValueError, match="contiguous"):
        moe_mod.moe_ffn(x, w, w.transpose(1, 2).contiguous().transpose(
            1, 2), wd)
    with pytest.raises(ValueError, match="w_gate"):
        moe_mod.moe_ffn(x, None, w, wd, act="swiglu")
    with pytest.raises(ValueError, match="shape"):
        moe_mod.moe_ffn(x, w, w, wd[:, :8])
    q = torch.zeros(1, 4, 8, device=cuda)
    kv = torch.zeros(1, 16, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="on cpu"):
        fd_mod.flash_decode(q, kv, kv.cpu(), 16)


def test_model_and_server_on_card_match_cpu(cuda):
    """The whole port on the card (kernels) against the same weights on
    the CPU (plain versions): logits, counts and served tokens."""
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    gpu = Model(cfg, device=cuda).init(3)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)))
    with torch.inference_mode():
        lg, ag = gpu.forward({"tokens": toks.to(cuda)})
        lc, ac = cpu.forward({"tokens": toks})
    np.testing.assert_allclose(_f32(lg), lc.numpy(), atol=1e-4, rtol=1e-4)
    assert torch.equal(ag["counts"].cpu(), ac["counts"])

    def serve(model, device):
        srv = TorchModelServer(
            EngineConfig(arch=cfg, gpu_cache_experts=3,
                         dram_cache_experts=6), model, cache_len=32,
            device=device)
        prompts = np.random.default_rng(1).integers(0, cfg.vocab, (3, 9))
        out, stats = srv.generate(prompts.astype(np.int32), 6)
        return out, stats, srv
    g_out, g_stats, g_srv = serve(gpu, cuda)
    c_out, c_stats, _ = serve(cpu, "cpu")
    np.testing.assert_array_equal(g_out, c_out)
    assert g_stats["demand_fetches"] == c_stats["demand_fetches"]
    assert len(g_srv.decode_ms) == g_srv.n_decode_steps > 0
