"""Training loop: train_step (loss = LM + MoE aux, backward, AdamW) + host
loop. The port of ``repro.train.loop``: eager autograd in place of a jitted
``value_and_grad``, with the parameters and moments updated in place. A
placed model (``launch/sharding.py::place``) takes the same step over its
DTensors, the batch laid out by ``batch_spec``."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.launch import sharding, spmd
from repro_torch.train.optim import (OptConfig, adamw_init, adamw_update,
                                     decay_mask)


@dataclass
class TrainState:
    params: Any          # {name: parameter} of the model, updated in place
    opt: Any
    step: int = 0


def make_train_step(model, opt_cfg: OptConfig, *, remat: bool = True,
                    capacity_factor: Optional[float] = None) -> Callable:
    """-> ``train_step(opt_state, batch) -> (loss, gnorm)`` (0-d tensors,
    plain on a placed model too), which updates ``model``'s parameters and
    ``opt_state`` in place. Makes every parameter trainable."""
    model.trainable()
    params = dict(model.named_parameters())
    decay = decay_mask(model)
    device_mesh = next((p.device_mesh for p in params.values()
                        if spmd.is_placed(p)), None)

    def train_step(opt_state, batch):
        for p in params.values():
            p.grad = None
        if device_mesh is not None:
            batch = sharding.place_batch(batch, device_mesh)
        with spmd.step_context(model):
            loss = model.loss(batch, remat=remat,
                              capacity_factor=capacity_factor)
            loss.backward()
        gnorm = adamw_update(opt_cfg, params,
                             {n: p.grad for n, p in params.items()},
                             opt_state, decay)
        return spmd.local(loss.detach()), gnorm
    return train_step


def to_batch(batch, device):
    """numpy batch -> tensors on ``device``: integer arrays (tokens,
    labels, positions) as int64, float arrays (embeddings) floating, as the
    reference's ``jnp.asarray`` keeps them (float64 as float32)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if t.dtype == torch.float64:
            t = t.float()
        elif not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def train_loop(model, data_iter, opt_cfg: OptConfig, *, n_steps: int = 100,
               log_every: int = 10, verbose: bool = True):
    """Train ``model`` (initialized, on its device) for ``n_steps`` batches
    of ``data_iter``. -> (TrainState, losses)."""
    step_fn = make_train_step(model, opt_cfg)
    params = dict(model.named_parameters())
    opt_state = adamw_init(params)
    losses = []
    t0 = time.time()
    for i, batch in enumerate(data_iter):
        if i >= n_steps:
            break
        loss, gnorm = step_fn(opt_state, to_batch(batch, model.device))
        losses.append(float(loss))
        if verbose and (i % log_every == 0 or i == n_steps - 1):
            print(f"step {i:5d} loss {float(loss):8.4f} "
                  f"gnorm {float(gnorm):7.3f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    # repro-lint: disable=donation-aliasing -- train_step updates opt_state in place and donates nothing; the rule knows the reference's jitted make_train_step by its name
    return TrainState(params=params, opt=opt_state, step=len(losses)), losses
