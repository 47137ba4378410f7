"""Jamba's loss curve under the train launcher's settings, on the port and
the reference with the same weights: phase 14's cut (jamba-1.5-large-398b,
1 layer, (mamba, dense)) at lr 1e-3 with 2 warm-up steps over 4 steps of
the launcher's batch (4 x 128 tokens from the first 4096 ids), in fp32 on
the CPU. The host cannot hold the cut at its published width in both
packages (2.1e9 parameters, ~34 GB each with AdamW), so both are narrowed
the same way (``NARROW``). Run with ``-s`` to see both curves."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro.train import OptConfig as JaxOptConfig
from repro.train import train_loop as jax_train_loop
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import Model
from repro_torch.params import from_reference
from repro_torch.train import OptConfig, train_loop
from repro_torch.train.data import DataConfig, TokenStream

torch.set_num_threads(2)

JAMBA = "jamba-1.5-large-398b"
# phase 14's cut with its widths divided by 8 (vocab and the Mamba state
# kept), in fp32
NARROW = dict(n_layers=1, d_model=1024, d_ff=3072, n_heads=8, n_kv_heads=1,
              dtype="float32")
STEPS, LR = 4, 1e-3


def test_jamba_loss_curve_matches_reference():
    """The port's 4 losses equal the reference's within 2e-3 relative
    (``test_launcher_matches_reference``'s tolerance after step 0)."""
    opt = dict(lr=LR, warmup_steps=2, total_steps=STEPS)
    batches = list(TokenStream(DataConfig(vocab=4096, seq_len=128,
                                          batch=4)).batches(STEPS))
    jm = JaxModel(dataclasses.replace(get_config(JAMBA), **NARROW))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    # the reference's step donates its parameters: hand it a copy
    _, want = jax_train_loop(jm, iter(batches), JaxOptConfig(**opt),
                             n_steps=STEPS, verbose=False,
                             params=jax.tree.map(jax.numpy.array, params))
    tm = from_reference(
        Model(dataclasses.replace(torch_get_config(JAMBA), **NARROW),
              device="cpu"), params)
    del params
    _, got = train_loop(tm, iter(batches), OptConfig(**opt), n_steps=STEPS,
                        verbose=False)
    print(f"\njamba cut to 1 layer, widths / 8, fp32, lr {LR}: reference "
          f"{want}, port {got}")
    np.testing.assert_allclose(got, want, rtol=2e-3)
