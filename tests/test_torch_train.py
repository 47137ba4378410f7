"""Training on the port (``repro_torch.train``, ``Model.loss``, the B1
backward, ``launch/train.py``) and the trace-mode engine, against the
reference on the CPU in fp32, with the reference's weights loaded through
``from_reference`` and the same numpy inputs fed to both."""
import contextlib
import dataclasses
import functools
import io
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.eam import EAMC as JaxEAMC
from repro.launch import train as jax_train_launch
from repro.models import Model as JaxModel
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import workload as jax_workload
from repro.serving.engine import RoutingOracle as JaxRoutingOracle
from repro.train import OptConfig as JaxOptConfig
from repro.train import optim as jax_optim
from repro.train import train_loop as jax_train_loop
from repro.train.data import DataConfig, TokenStream
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.eam import EAMC
from repro_torch.examples import quickstart, train_moe
from repro_torch.kernels import ref
from repro_torch.kernels.moe_ffn import moe_ffn_backward
from repro_torch.launch import train as torch_train_launch
from repro_torch.models import Model
from repro_torch.params import from_reference, reference_leaves
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving import workload as torch_workload
from repro_torch.serving.engine import RoutingOracle
from repro_torch.train import OptConfig, train_loop
from repro_torch.train import optim
from repro_torch.train.checkpoint import BF16_KEY, restore, save
from repro_torch.train.loop import to_batch

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=1e-4)   # tests/test_kernels.py::_tol, fp32
QWEN3, DEEPSEEK = "qwen3-moe-235b-a22b", "deepseek-v2-236b"


def _np(t):
    return t.detach().cpu().numpy()


def _pair(arch, **repl):
    """(reference model, its numpy params, the port's model with them)."""
    jm = JaxModel(dataclasses.replace(get_config(arch).reduced(), **repl))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = Model(dataclasses.replace(torch_get_config(arch).reduced(), **repl),
               device="cpu")
    return jm, params, from_reference(tm, params)


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_reference():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    got = [optim.lr_schedule(OptConfig(**cfg), s) for s in range(120)]
    want = [float(jax_optim.lr_schedule(JaxOptConfig(**cfg), jnp.int32(s)))
            for s in range(120)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [0.01, 100.0],
                         ids=["unclipped", "clipped"])
def test_adamw_update_and_global_norm_match_reference(grad_scale):
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 6), "b": (6,), "s": (3, 4, 5)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = dict(lr=0.1, warmup_steps=1, total_steps=5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jax_optim.adamw_init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tstate = optim.adamw_init(tp)
    for _ in range(3):
        grads = {k: (rng.normal(size=s) * grad_scale).astype(np.float32)
                 for k, s in shapes.items()}
        jp, jstate, jn = jax_optim.adamw_update(
            JaxOptConfig(**cfg), jp, {k: jnp.asarray(g)
                                      for k, g in grads.items()}, jstate)
        tn = optim.adamw_update(OptConfig(**cfg), tp,
                                {k: torch.tensor(g) for k, g in grads.items()},
                                tstate, {k: v.ndim >= 2
                                         for k, v in params.items()})
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert float(tn) == pytest.approx(float(jax_optim.global_norm(
            {k: jnp.asarray(g) for k, g in grads.items()})), rel=1e-6)
        for k in shapes:
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), **TOL)
            for m in ("mu", "nu"):
                np.testing.assert_allclose(_np(tstate[m][k]),
                                           np.asarray(jstate[m][k]), **TOL)
    assert tstate["step"] == int(jstate["step"]) == 3


@pytest.mark.parametrize("arch", [QWEN3, DEEPSEEK, "whisper-small"])
def test_decay_mask_follows_the_reference_layout(arch):
    """The reference decays a leaf of ndim >= 2; its scan groups and
    encoder stack layers, so a norm scale decays there and not in a prefix
    layer. Reduced qwen3-moe is all scan groups, reduced DeepSeek-V2 all
    prefix (a dense layer, then an MoE one), whisper's encoder stacked.
    Two AdamW steps over the model's parameters with the same gradients
    give the reference's parameters."""
    _, params, tm = _pair(arch)
    flags = jax.tree.map(lambda a: np.full(a.shape, a.ndim >= 2), params)
    want = {n: bool(a.flat[0])
            for n, a in reference_leaves(tm, flags).items()}
    mask = optim.decay_mask(tm)
    assert mask == want
    one_d = {n for n, p in tm.named_parameters() if p.dim() == 1}
    decayed_1d = {n for n in one_d if mask[n]}
    if arch == DEEPSEEK:
        assert tm.n_groups == 0 and not decayed_1d
    else:
        assert tm.n_prefix == 0 and decayed_1d == {
            n for n in one_d if n.startswith(("layers.", "encoder."))}

    rng = np.random.default_rng(1)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=4)
    tparams = dict(tm.named_parameters())
    tstate = optim.adamw_init(tparams)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jax_optim.adamw_init(jp)
    update = jax.jit(functools.partial(jax_optim.adamw_update,
                                       JaxOptConfig(**cfg)))
    for _ in range(2):
        grads = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        jp, jstate, _ = update(jp, jax.tree.map(jnp.asarray, grads), jstate)
        tg = {n: torch.tensor(g)
              for n, g in reference_leaves(tm, grads).items()}
        optim.adamw_update(OptConfig(**cfg), tparams, tg, tstate, mask)
    got = reference_leaves(tm, jax.tree.map(np.asarray, jp))
    for n, p in tparams.items():
        np.testing.assert_allclose(_np(p), got[n], err_msg=n, **TOL)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[QWEN3, "qwen3-1.7b", DEEPSEEK])
def arch(request):
    return request.param


# (remat, remat_policy, capacity_factor, labels): cf 0.5 drops tokens
# (capacity 7 for 48 assignments over 4 experts)
LOSS_CASES = [(False, "full", None, False), (True, "full", None, False),
              (True, "dots", 0.5, True)]


LOSS_IDS = ["plain", "remat-full", "remat-dots-cf0.5"]


def family_batch(cfg, rng, B=2, S=12, labels=False):
    """A numpy training batch for ``cfg``'s family: tokens (+ labels); for
    Qwen2-VL seeded ``embeds`` with (3, B, S) positions whose planes differ
    and labels; for Whisper seeded ``enc_embeds`` too."""
    V, d = cfg.vocab, cfg.d_model
    if cfg.attn.mrope_sections:
        pos = np.stack([np.arange(S), np.arange(S) // 2, np.arange(S) % 3])
        batch = {"embeds": (rng.standard_normal((B, S, d))
                            * d ** -0.5).astype(np.float32),
                 "positions": np.broadcast_to(pos[:, None], (3, B, S))
                 .astype(np.int32).copy(),
                 "labels": rng.integers(0, V, (B, S)).astype(np.int32)}
    else:
        batch = {"tokens": rng.integers(0, V, (B, S)).astype(np.int32)}
        if labels:
            batch["labels"] = rng.integers(0, V, (B, S)).astype(np.int32)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, d)).astype(np.float32)
    return batch


def check_loss_and_every_gradient(arch, remat, policy, cf, labels):
    """``Model.loss`` and every parameter's gradient against
    ``jax.value_and_grad(model.loss)`` on the reduced config. A parameter
    the loss does not reach (the embedding table under ``embeds``) has no
    gradient on the port and a zero one in the reference."""
    jm, params, tm = _pair(arch, remat_policy=policy)
    tm.trainable()
    batch = family_batch(jm.cfg, np.random.default_rng(0), labels=labels)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                          capacity_factor=cf, remat=remat)))(
        jax.tree.map(jnp.asarray, params))
    tl = tm.loss(to_batch(batch, "cpu"), capacity_factor=cf, remat=remat)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    want = reference_leaves(tm, jax.tree.map(np.asarray, jg))
    for n, p in tm.named_parameters():
        if p.grad is None:
            assert "embeds" in batch and not np.any(want[n]), n
            continue
        np.testing.assert_allclose(_np(p.grad), want[n], err_msg=n, **TOL)


@pytest.mark.parametrize("remat,policy,cf,labels", LOSS_CASES, ids=LOSS_IDS)
def test_loss_and_every_gradient_match_reference(arch, remat, policy, cf,
                                                 labels):
    check_loss_and_every_gradient(arch, remat, policy, cf, labels)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu2", "gelu"])
def test_b1_backward_matches_autograd_through_plain(act):
    """The B1 Function's backward products on CPU tensors against autograd
    through ``moe_ffn_ref``, with unrouted (zero) rows and a whole expert
    of them, as the dispatch leaves them."""
    E, C, d, f = 3, 7, 16, 24
    rng = np.random.default_rng(2)

    def t(*shape, std=1.0):
        return torch.tensor(rng.normal(size=shape).astype(np.float32) * std)
    xg = t(E, C, d)
    xg[0, 4:] = 0.0
    xg[2] = 0.0
    wg = t(E, d, f, std=d ** -0.5) if act in ("swiglu", "geglu") else None
    wu, wd = t(E, d, f, std=d ** -0.5), t(E, f, d, std=f ** -0.5)
    dy = t(E, C, d)
    ins = [x.requires_grad_() for x in (xg, wg, wu, wd) if x is not None]
    y = ref.moe_ffn_ref(xg, wg, wu, wd, act=act)
    want = torch.autograd.grad(y, ins, dy)
    got = [g for g in moe_ffn_backward(xg.detach(), wg, wu, wd, dy, act=act)
           if g is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


# ---------------------------------------------------------------------------
# training loop, checkpoint, launcher
# ---------------------------------------------------------------------------


def _close_after_steps(init, got_params, want, lr):
    """Parameters after AdamW steps: Adam divides by √v̂ + eps, so where a
    gradient is near eps its fp32 rounding (~1e-9) moves the update of
    that element by a fraction of lr; a few elements in 1e5 show it. So
    each element within 0.25 lr, and each tensor's update within 2e-3 of
    the reference's in L2 norm (a missed or extra weight decay moves a
    norm scale's update by ~10 %)."""
    for n, p in got_params.items():
        got = _np(p)
        np.testing.assert_allclose(got, want[n], atol=0.25 * lr, rtol=0,
                                   err_msg=n)
        du, dw = got - init[n], want[n] - init[n]
        assert np.linalg.norm(du - dw) <= 2e-3 * np.linalg.norm(dw), n


@pytest.mark.parametrize("arch5", [QWEN3, DEEPSEEK])
def test_five_train_steps_match_reference(arch5):
    jm, params, tm = _pair(arch5)
    init = {n: _np(p).copy() for n, p in tm.named_parameters()}
    data = TokenStream(DataConfig(vocab=512, seq_len=16, batch=2))
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    js, jl = jax_train_loop(jm, data.batches(5), JaxOptConfig(**kw),
                            params=jax.tree.map(jnp.asarray, params),
                            n_steps=5, verbose=False)
    ts, tl = train_loop(tm, data.batches(5), OptConfig(**kw), n_steps=5,
                        verbose=False)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert ts.step == js.step == 5
    _close_after_steps(init, ts.params,
                       reference_leaves(tm, jax.tree.map(np.asarray,
                                                         js.params)),
                       kw["lr"])
    for m in ("mu", "nu"):
        want = reference_leaves(tm, jax.tree.map(np.asarray, js.opt[m]))
        for n, v in ts.opt[m].items():
            np.testing.assert_allclose(_np(v), want[n], err_msg=n, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_roundtrip(tmp_path, dtype):
    """tests/test_train.py's round trip on the port: every parameter comes
    back bit for bit (bf16 through its raw 16 bits); a shape mismatch
    raises."""
    cfg = dataclasses.replace(torch_get_config("qwen3-1.7b").reduced(),
                              dtype=dtype)
    model = Model(cfg, device="cpu").init(0)
    path = str(tmp_path / "ckpt.npz")
    save(path, model)
    restored = restore(path, Model(cfg, device="cpu"))
    dtypes = set()
    for (n, a), (_, b) in zip(model.named_parameters(),
                              restored.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
        dtypes.add(a.dtype)
    assert getattr(torch, dtype) in dtypes
    wider = dataclasses.replace(cfg, d_model=cfg.d_model * 2)
    with pytest.raises(ValueError, match="checkpoint shape"):
        restore(path, Model(wider, device="cpu"))


@pytest.mark.parametrize("src,dst", [("bfloat16", "float32"),
                                     ("float32", "bfloat16"),
                                     ("bfloat16", "bfloat16")])
def test_checkpoint_restores_into_another_dtype(tmp_path, src, dst):
    """Each parameter comes back as the reference's ``arr.astype(dtype)``
    of what was saved: bf16 -> fp32 exactly, fp32 -> bf16 rounded to
    nearest, bf16 -> bf16 bit for bit."""
    cfg = torch_get_config("qwen3-1.7b").reduced()
    model = Model(dataclasses.replace(cfg, dtype=src), device="cpu").init(0)
    path = str(tmp_path / "ckpt.npz")
    save(path, model)
    back = restore(path, Model(dataclasses.replace(cfg, dtype=dst),
                               device="cpu"))
    casts = set()
    for (n, a), (_, b) in zip(model.named_parameters(),
                              back.named_parameters()):
        want = _np(a.float()).astype(
            ml_dtypes.bfloat16 if b.dtype == torch.bfloat16 else np.float32)
        np.testing.assert_array_equal(_np(b.float()), want.astype(np.float32),
                                      err_msg=n)
        if a.dtype == b.dtype == torch.bfloat16:
            assert torch.equal(a.view(torch.int16), b.view(torch.int16)), n
        casts.add((a.dtype, b.dtype))
    assert (getattr(torch, src), getattr(torch, dst)) in casts


def test_checkpoint_without_the_bf16_key_restores(tmp_path):
    """A checkpoint written before ``BF16_KEY`` existed (bf16 as int16
    bits, nothing listed) restores bit for bit into a bf16 model and as
    values into an fp32 one."""
    cfg = dataclasses.replace(torch_get_config("qwen3-1.7b").reduced(),
                              dtype="bfloat16")
    model = Model(cfg, device="cpu").init(0)
    path = str(tmp_path / "old.npz")
    np.savez(path, **{n: _np(p.view(torch.int16) if p.dtype == torch.bfloat16
                            else p) for n, p in model.named_parameters()})
    bf16 = restore(path, Model(cfg, device="cpu"))
    fp32 = restore(path, Model(dataclasses.replace(cfg, dtype="float32"),
                               device="cpu"))
    for (n, a), b, c in zip(model.named_parameters(), bf16.parameters(),
                            fp32.parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(a.float(), c), n


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-72b"])
def test_train_loop_keeps_float_inputs(arch):
    """One ``train_loop`` step on a batch with float fields (Whisper's
    ``enc_embeds``, Qwen2-VL's ``embeds``) gives the reference
    ``train_loop``'s loss: the fields stay floating."""
    jm, params, tm = _pair(arch)
    batch = family_batch(jm.cfg, np.random.default_rng(4))
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=2)
    _, jl = jax_train_loop(jm, iter([batch]), JaxOptConfig(**kw),
                           params=jax.tree.map(jnp.asarray, params),
                           n_steps=1, verbose=False)
    _, tl = train_loop(tm, iter([batch]), OptConfig(**kw), n_steps=1,
                       verbose=False)
    np.testing.assert_allclose(tl, jl, **TOL)
    got = to_batch(batch, "cpu")
    for k, v in batch.items():
        assert got[k].is_floating_point() == (v.dtype.kind == "f"), k


def _lines(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return [tuple(float(v) for v in re.findall(
        r"loss (\S+) gnorm (\S+)", line)[0])
        for line in buf.getvalue().splitlines() if line.startswith("step")]


def test_launcher_matches_reference(tmp_path):
    """``launch/train.py --reduced --steps 3 --device cpu`` with the
    reference's seed-0 weights prints the reference launcher's losses and
    gradient norms (to their printed digits), and saves a checkpoint."""
    jax_lines = _lines(lambda: jax_train_launch.main(["--reduced",
                                                      "--steps", "3"]))
    path = str(tmp_path / "ck.npz")
    args = torch_train_launch.parse_args(["--reduced", "--steps", "3",
                                          "--device", "cpu", "--ckpt", path])
    cfg = torch_train_launch.config(args)
    params = JaxModel(get_config(QWEN3).reduced()).init(
        jax.random.PRNGKey(0))
    model = from_reference(Model(cfg, device="cpu"),
                           jax.tree.map(np.asarray, params))
    out = {}
    lines = _lines(lambda: out.update(
        torch_train_launch.train(args, cfg, model)))
    assert len(lines) == len(jax_lines) == 3
    # step 0 to its printed digits; later steps follow an AdamW update in
    # which the few elements whose gradient is near eps move by a fraction
    # of lr differently under fp32 rounding (see _close_after_steps), and
    # at seq 128 one near-tied routing decision then moves the loss by
    # ~1e-4 and the gradient norm by ~1e-3 relative
    np.testing.assert_allclose(lines[0], jax_lines[0], atol=1.5e-3, rtol=0)
    np.testing.assert_allclose(lines[1:], jax_lines[1:], rtol=2e-3)
    assert out["losses"][-1] < out["losses"][0]
    assert np.allclose(lines, [(round(a, 4), round(b, 3)) for a, b in
                               zip(out["losses"], out["gnorms"])])
    with np.load(path) as ck:
        assert set(ck.files) == {n for n, _ in model.named_parameters()} \
            | {BF16_KEY}
    # --mesh debug without a launcher: a one-rank gloo group in this
    # process, a (1, 1) mesh, the unsharded lines to every digit
    placed = from_reference(Model(cfg, device="cpu"),
                            jax.tree.map(np.asarray, params))
    args = torch_train_launch.parse_args(["--reduced", "--steps", "3",
                                          "--device", "cpu", "--mesh",
                                          "debug"])
    mesh_out = {}
    assert _lines(lambda: mesh_out.update(
        torch_train_launch.train(args, cfg, placed))) == lines
    assert mesh_out["losses"] == out["losses"]
    for (n, p), q in zip(model.named_parameters(), placed.parameters()):
        assert torch.equal(p.detach(), q.to_local().detach()), n
    assert torch_train_launch.config(torch_train_launch.parse_args(
        ["--layers", "1"])).n_layers == 1


def test_examples_run_on_cpu(tmp_path, capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "EAMC built" in out and "gpu cache hit ratio" in out
    l1, l2 = train_moe.main(["--device", "cpu", "--steps", "2", "--layers",
                             "2", "--ckpt", str(tmp_path / "m.npz")])
    assert abs(l1 - l2) < 1e-6


# ---------------------------------------------------------------------------
# trace-mode engine
# ---------------------------------------------------------------------------


def test_trace_engine_stats_equal_reference():
    """``ServingEngine`` over a ``RoutingOracle`` (the copies) serves the
    same seeded trace as the reference's with equal ``stats()``."""
    arch = get_config("switch-base-128")
    n_moe = sum(arch.is_moe_layer(i) for i in range(arch.n_layers))
    E = arch.moe.n_experts

    def run(oracle_cls, eamc_cls, cfg_cls, engine_cls, workload, arch):
        oracle = oracle_cls(n_layers=n_moe, n_experts=E, n_tasks=3, top_k=1,
                            seed=7)
        rng = np.random.default_rng(1)
        eams = []
        for i in range(20):
            eam = np.zeros((n_moe, E))
            for it in range(8):
                eam += oracle.route_tokens(i % 3, 16 if it == 0 else 1, rng)
            eams.append(eam)
        eamc = eamc_cls(capacity=12)
        eamc.construct(eams)
        cfg = cfg_cls(arch=arch, gpu_cache_experts=60,
                      dram_cache_experts=300, bytes_per_param=4)
        eng = engine_cls(cfg, eamc=eamc, oracle=oracle, seed=3)
        reqs = workload.make_dataset(workload.WorkloadConfig(
            prompt_len=(8, 24), output_len=(4, 12)), 12, seed=3)
        workload.attach_arrivals(reqs, workload.azure_like_arrivals(
            12, rps=4.0, seed=4))
        eng.run(reqs)
        return eng.stats()

    want = run(JaxRoutingOracle, JaxEAMC, JaxEngineConfig, JaxServingEngine,
               jax_workload, arch)
    got = run(RoutingOracle, EAMC, EngineConfig, ServingEngine,
              torch_workload, torch_get_config("switch-base-128"))
    assert got == want
    assert want["decode_tokens"] > 0
