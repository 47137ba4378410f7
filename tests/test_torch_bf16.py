"""The port in bfloat16, the dtype every published config and so every
full-width path on the card runs, held against the reference in
bfloat16 on the CPU.

Both sides take the same ``.reduced()`` config with ``dtype="bfloat16"``:
the reference's bf16 weights, loaded into the port through
``from_reference``, and the same numpy inputs made from a seed. Two bf16
runs differ from each other by about as much as each differs from exact
arithmetic, so they are not compared with each other. The yardstick is
the reference run in fp32 on the same weights upcast to fp32.

**The criterion.** For an output ``y``, the normwise error of a run is
``||y - y_fp32|| / ||y_fp32||`` over all its elements. The port's error
may be at most twice the reference's own bf16 error, plus a floor of
1e-3::

    err(port bf16) <= 2 * err(reference bf16) + 1e-3

It holds for the logits, prefill's cache rows (every leaf, the first
``true_len`` positions of an attention cache), and a training step's loss
and each parameter's gradient. MoE routing may flip in bf16, so the
counts are held in two ways: the totals are equal (every real token routes
top-k in every MoE layer, pads and idle slots route nowhere), and the
token-expert assignments that differ from the yardstick's (half the summed
absolute difference of the counts) are at most twice the reference's,
plus one.

Decode is teacher-forced: every run takes the yardstick's greedy tokens,
so that one flipped token cannot end the comparison.

This file holds forward, padded prefill and four gated pooled decode steps
of the first five architectures of ``ALL_ARCHS``;
``test_torch_bf16_archs.py`` and ``test_torch_bf16_families.py`` hold the
rest, and ``test_torch_bf16_stream_train.py`` the streaming decode over
each wire and one training step's loss and gradients.

``PYTHONPATH=src:tests python tests/test_torch_bf16.py`` prints each
architecture's largest error of the port and of the reference under each
entry point, and the largest share of the bound the port uses."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import Model
from repro_torch.params import from_reference

torch.set_num_threads(2)

FLOOR = 1e-3
# every arch of tests/test_torch_model.py::ARCHS, then rwkv6-7b, jamba and
# whisper-small; held here in three files of about equal time
ALL_ARCHS = ["qwen3-moe-235b-a22b", "qwen2-1.5b", "qwen3-1.7b",
             "nemotron-4-15b", "switch-base-128",
             "switch-base-256", "switch-large-128", "nllb-moe-128",
             "deepseek-v2-236b", "gemma2-2b",
             "qwen2-vl-72b", "rwkv6-7b", "jamba-1.5-large-398b",
             "whisper-small"]
ARCHS = ALL_ARCHS[:5]
B, L, P = 3, 32, 16                 # pool rows, cache length, prompt bucket
PROMPTS = ((0, 7), (2, 12))         # (pool row, real length); row 1 idle
ACTIVE = np.array([True, False, True])
N_STEPS = 4


def normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def check(what, port, ref16, ref32):
    """The criterion on one output: port, reference bf16, fp32 yardstick
    (numpy-convertible)."""
    e_port, e_ref = normwise(port, ref32), normwise(ref16, ref32)
    assert e_port <= 2 * e_ref + FLOOR, \
        f"{what}: port {e_port:.3e} > 2 x reference {e_ref:.3e} + {FLOOR}"
    return e_port, e_ref


def moved(counts, want) -> float:
    """Token-expert assignments that differ between two count arrays."""
    return float(np.abs(np.asarray(counts, np.int64)
                        - np.asarray(want, np.int64)).sum()) / 2


def check_counts(what, port, ref16, ref32, tokens, k):
    """Equal totals per (layer, row), ``tokens * k``; moved assignments at
    most twice the reference's, plus one. Counts are None on both sides
    of a dense stack."""
    if ref32 is None:
        assert port is None and ref16 is None, what
        return
    port, ref16, ref32 = (np.asarray(c, np.int64) for c in
                          (port, ref16, ref32))
    np.testing.assert_array_equal(port.sum(-1), ref32.sum(-1), err_msg=what)
    np.testing.assert_array_equal(ref16.sum(-1), ref32.sum(-1),
                                  err_msg=what)
    np.testing.assert_array_equal(
        ref32.sum(-1), np.broadcast_to(np.asarray(tokens) * k,
                                       ref32.shape[:-1]), err_msg=what)
    assert moved(port, ref32) <= 2 * moved(ref16, ref32) + 1, \
        f"{what}: {moved(port, ref32)} assignments moved, reference " \
        f"{moved(ref16, ref32)}"


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _upcast(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


class Trio:
    """The reference in bf16 and in fp32 (the yardstick, on the bf16
    weights upcast), and the port in bf16 with the same weights."""

    def __init__(self, arch, **repl):
        base = dataclasses.replace(get_config(arch).reduced(), **repl)
        self.cfg = base
        self.j16 = JaxModel(dataclasses.replace(base, dtype="bfloat16"))
        self.j32 = JaxModel(base)
        p16 = self.j16.init(jax.random.PRNGKey(0))
        self.np16 = jax.tree.map(np.asarray, p16)
        assert any(a.dtype.name == "bfloat16"
                   for a in jax.tree.leaves(self.np16))
        self.p16 = p16
        self.p32 = jax.tree.map(lambda a: jnp.asarray(_upcast(a)),
                                self.np16)
        self.tcfg = dataclasses.replace(
            torch_get_config(arch).reduced(), dtype="bfloat16", **repl)
        # (model, params, its jitted entry points): reference bf16, then
        # the fp32 yardstick; each compiles once per shape
        self.refs = [(m, p, {
            "forward": jax.jit(m.forward),
            "prefill": jax.jit(lambda p, b, c, n, m=m: m.prefill(
                p, b, c, true_len=n)),
            "step": jax.jit(lambda p, c, t, a, m=m: m.serve_step(
                p, c, t, active=a))})
            for m, p in ((self.j16, self.p16), (self.j32, self.p32))]

    def port(self):
        """A fresh port model holding the reference's bf16 weights."""
        return from_reference(Model(self.tcfg, device="cpu"), self.np16)

    @property
    def k(self):
        return self.cfg.moe.top_k if self.cfg.moe is not None else None


def batch_for(cfg, rng, Bn, S, Pn=None):
    """Numpy inputs: tokens right-padded to ``Pn``; Whisper's encoder
    inputs as ``enc_embeds``."""
    Pn = Pn or S
    toks = np.zeros((Bn, Pn), np.int64)
    toks[:, :S] = rng.integers(0, cfg.vocab, (Bn, S))
    batch = {"tokens": toks}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = rng.standard_normal(
            (Bn, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def unroll(cache, n_prefix, n_groups):
    """The reference's cache as one dict per layer (prefix layers, then
    each scan group's slice of the periodic blocks)."""
    layers = list(cache["prefix"])
    for g in range(n_groups):
        layers += [jax.tree.map(lambda a: a[g], blk)
                   for blk in cache["blocks"]]
    return layers


def run_forward(trio):
    tm = trio.port()
    batch = batch_for(trio.cfg, np.random.default_rng(3), 2, 24)
    outs = [fns["forward"](p, to_jax(batch)) for _, p, fns in trio.refs]
    with torch.inference_mode():
        tl, taux = tm.forward(to_torch(batch))
    errs = check("logits", np32(tl), np32(outs[0][0]), np32(outs[1][0]))
    check_counts("counts", taux["counts"], outs[0][1]["counts"],
                 outs[1][1]["counts"], tokens=24, k=trio.k)
    return errs


def run_prefill(trio):
    """Padded prefill of one prompt: logits, counts and every cache leaf
    (attention rows up to ``true_len``)."""
    tm = trio.port()
    S = 11
    batch = batch_for(trio.cfg, np.random.default_rng(4), 1, S, P)
    refs = [fns["prefill"](p, to_jax(batch), m.init_cache(1, L), S)
            for m, p, fns in trio.refs]
    with torch.inference_mode():
        tl, tc, taux = tm.prefill(to_torch(batch), tm.init_cache(1, L),
                                  true_len=S)
    errs = [check("logits", np32(tl), np32(refs[0][0]), np32(refs[1][0]))]
    check_counts("counts", taux["counts"], refs[0][2]["counts"],
                 refs[1][2]["counts"], tokens=S, k=trio.k)
    assert int(tc["pos"][0]) == S
    j16 = unroll(refs[0][1], tm.n_prefix, tm.n_groups)
    j32 = unroll(refs[1][1], tm.n_prefix, tm.n_groups)
    assert len(j16) == len(tc["layers"])
    for i, (t, a, b) in enumerate(zip(tc["layers"], j16, j32)):
        assert sorted(t) == sorted(a), i
        for key, val in t.items():
            rows = slice(None)
            if key in ("k", "v", "ckv", "kr"):
                rows = (slice(None), slice(0, S))
            errs.append(check(f"layer {i} {key}", np32(val)[rows],
                              np32(a[key])[rows], np32(b[key])[rows]))
    return errs


def run_decode(trio):
    """Two prompts prefilled (padded) into a 3-row pool, one row idle,
    then ``N_STEPS`` gated decode steps, teacher-forced by the
    yardstick's greedy tokens: each step's logits on the active rows and
    its counts."""
    tm = trio.port()
    rng = np.random.default_rng(5)
    pools = [m.init_cache(B, L) for m, _, _ in trio.refs]
    tpool = tm.init_cache(B, L)
    tok = np.zeros(B, np.int64)
    errs = []
    with torch.inference_mode():
        for slot, S in PROMPTS:
            batch = batch_for(trio.cfg, rng, 1, S, P)
            outs = []
            for i, (m, p, fns) in enumerate(trio.refs):
                jl, one, _ = fns["prefill"](p, to_jax(batch),
                                            m.init_cache(1, L), S)
                pools[i] = m.write_slot(pools[i], one, slot)
                outs.append(jl)
            tl, tone, _ = tm.prefill(to_torch(batch), tm.init_cache(1, L),
                                     true_len=S)
            tm.write_slot(tpool, tone, slot)
            tok[slot] = int(np.argmax(np32(outs[1])[0]))
        for n in range(N_STEPS):
            outs = []
            for i, (_, p, fns) in enumerate(trio.refs):
                jl, pools[i], jaux = fns["step"](
                    p, pools[i], jnp.asarray(tok, jnp.int32),
                    jnp.asarray(ACTIVE))
                outs.append((np32(jl), jaux["counts"]))
            tl, tpool, taux = tm.serve_step(
                tpool, torch.from_numpy(tok),
                active=torch.from_numpy(ACTIVE))
            errs.append(check(f"step {n} logits", np32(tl)[ACTIVE],
                              outs[0][0][ACTIVE], outs[1][0][ACTIVE]))
            check_counts(f"step {n} counts", taux["counts"], outs[0][1],
                         outs[1][1], tokens=ACTIVE.astype(np.int64),
                         k=trio.k)
            tok = np.where(ACTIVE, np.argmax(outs[1][0], -1), tok)
    np.testing.assert_array_equal(np32(tpool["pos"]),
                                  np32(pools[1]["pos"]))
    return errs


@pytest.fixture(scope="module", params=ARCHS)
def trio(request):
    return Trio(request.param)


def test_forward_within_bf16_criterion(trio):
    run_forward(trio)


def test_padded_prefill_within_bf16_criterion(trio):
    run_prefill(trio)


def test_teacher_forced_decode_within_bf16_criterion(trio):
    run_decode(trio)


def main():
    """Print, per architecture and entry point, the largest normwise error
    from the fp32 yardstick of the port and of the reference (both bf16)
    over the outputs that entry point checks, and the largest share of
    the criterion's bound the port uses (at most 1 passes)."""
    print("arch,entry,outputs,port_err,reference_err,share_of_bound")
    for arch in ALL_ARCHS:
        trio = Trio(arch)
        for name, run in (("forward", run_forward), ("prefill", run_prefill),
                          ("decode", run_decode)):
            errs = run(trio)
            errs = [errs] if isinstance(errs, tuple) else errs
            share = max(e / (2 * r + FLOOR) for e, r in errs)
            print(f"{arch},{name},{len(errs)},{max(e for e, _ in errs):.4e},"
                  f"{max(r for _, r in errs):.4e},{share:.3f}")


if __name__ == "__main__":
    main()
