"""The streaming decode of reduced qwen3-moe through ``SlotStreamRuntime``
over each wire (fp32, fp16, int8), and one training step's loss and
gradients (before AdamW) of qwen3-moe, rwkv6-7b and Jamba, the three
full-width training legs on the card, in bf16, held against the reference
by ``test_torch_bf16.py``'s criterion.

The streaming yardstick is the reference's ``SlotStreamRuntime`` in fp32
on the upcast weights over the same wire. The runtimes return greedy
tokens only, so each side's logits are read where it computes them: the
reference's tail is replaced by one that keeps them (the same norm, head
and argmax), and the port's ``_logits`` is wrapped."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import apply_norm
from repro.serving.slot_runtime import \
    SlotStreamRuntime as JaxSlotStreamRuntime
from repro_torch.params import reference_leaves
from repro_torch.serving.slot_runtime import SlotStreamRuntime
from repro_torch.train.loop import to_batch
from test_torch_bf16 import ACTIVE, B, L, N_STEPS, P, PROMPTS, Trio, \
    check, check_counts, np32
from test_torch_train import family_batch

torch.set_num_threads(2)

QWEN3 = "qwen3-moe-235b-a22b"
N_WEIGHT_SLOTS = 4               # of 2 MoE layers x 4 experts


@pytest.fixture(scope="module")
def qwen3():
    return Trio(QWEN3)


class _TappedReference(JaxSlotStreamRuntime):
    """The reference runtime, keeping each prefill's and decode step's
    logits in ``logits``."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.logits = []

    def _tail(self, key, last):
        def build():
            model = self.model

            def impl(params, x, *tl):
                x_last = apply_norm(params["final_norm"], last(x, *tl))
                return model._logits(params, x_last)[:, 0]
            return jax.jit(impl)
        fn = self._fn(key, build)

        def run(params, x, *tl):
            logits = fn(params, x, *tl)
            self.logits.append(np32(logits))
            return jnp.argmax(logits, axis=-1)
        return run

    def _decode_tail(self):
        return self._tail("tapped_tail", lambda x: x)

    def _prefill_tail(self, P):
        return self._tail(("tapped_prefill_tail", P), lambda x, tl: (
            jnp.take_along_axis(x, (tl - 1)[:, None, None], axis=1)))


def _tap_port(rt):
    rt.logits = []
    orig = rt.model._logits

    def tapped(x):
        out = orig(x)
        rt.logits.append(np32(out[:, -1]))
        return out
    rt.model._logits = tapped
    return rt


@pytest.mark.parametrize("wire", ["fp32", "fp16", "int8"])
def test_streaming_decode_within_bf16_criterion(qwen3, wire):
    """Two prompts prefilled (padded) into a 3-row pool through the slot
    runtime, one row idle, then teacher-forced gated decode steps, with
    half the experts' slots: each prefill's and step's logits and
    counts."""
    trio = qwen3
    kw = dict(n_pool_slots=B, n_weight_slots=N_WEIGHT_SLOTS,
              transfer_dtype=wire)
    refs = [_TappedReference(m, p, **kw) for m, p, _ in trio.refs]
    port = _tap_port(SlotStreamRuntime(trio.port(), **kw))
    runs = [port] + refs                  # port, reference bf16, fp32
    for rt in runs:
        rt.build_pool(L)
    rng = np.random.default_rng(6)
    tok = np.zeros(B, np.int64)
    for slot, S in PROMPTS:
        padded = np.zeros(P, np.int32)
        padded[:S] = rng.integers(0, trio.cfg.vocab, S)
        outs = [rt.prefill(padded, S, slot) for rt in runs]
        check(f"prefill {slot} logits", *(rt.logits[-1] for rt in runs))
        check_counts(f"prefill {slot} counts", *(c for _, c in outs),
                     tokens=S, k=trio.k)
        tok[slot] = outs[2][0]
    for n in range(N_STEPS):
        outs = [rt.decode(tok, ACTIVE) for rt in runs]
        check(f"step {n} logits",
              *(rt.logits[-1][ACTIVE] for rt in runs))
        check_counts(f"step {n} counts", *(c for _, c in outs),
                     tokens=ACTIVE.astype(np.int64), k=trio.k)
        tok = np.where(ACTIVE, outs[2][0], tok)
    assert len(port.logits) == len(refs[0].logits) == 2 + N_STEPS
    for rt in runs:
        np.testing.assert_array_equal(rt.pos,
                                      [7 + N_STEPS, 0, 12 + N_STEPS])
    st = port.slot_cache.stats()
    assert st["demand_uploads"] > 0
    assert st["weight_slots"] == N_WEIGHT_SLOTS


@pytest.mark.parametrize("arch", [QWEN3, "rwkv6-7b",
                                  "jamba-1.5-large-398b"])
def test_train_step_loss_and_gradients_within_bf16_criterion(arch):
    """``Model.loss`` and every parameter's gradient (before the
    optimizer) against ``jax.value_and_grad(model.loss)``."""
    trio = Trio(arch)
    batch = family_batch(trio.cfg, np.random.default_rng(0), labels=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = [jax.jit(jax.value_and_grad(lambda p, m=m: m.loss(p, jb)))(p)
             for m, p, _ in trio.refs]
    tm = trio.port().trainable()
    tl = tm.loss(to_batch(batch, "cpu"))
    tl.backward()
    check("loss", np32(tl), *(np32(l) for l, _ in grads))
    want = [{k: np32(v) for k, v in reference_leaves(
        tm, jax.tree.map(np.asarray, g)).items()} for _, g in grads]
    n = 0
    for name, p in tm.named_parameters():
        assert p.grad is not None and p.grad.dtype == p.dtype, name
        check(f"grad {name}", np32(p.grad), want[0][name], want[1][name])
        n += 1
    assert n == len(want[1])
