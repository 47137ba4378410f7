"""Training launcher of the port: the same flags, defaults and printed
lines as ``repro.launch.train``, plus ``--device`` and ``--layers`` (a
depth cut, so that a full-width model fits one card).

Trains a ``repro_torch`` model (weights drawn from seed 0 on the device)
with AdamW on the synthetic Markov task mixture, remat on, and optionally
saves a checkpoint. The data draws from the first ``DATA_VOCAB`` ids at
most: its transition tables are quadratic in the vocabulary.

``--mesh debug`` shards the step over a (1, N) ("data", "model") mesh, N
the ranks of the group: one process a device, as ``torch.distributed.run``
starts them (without a launcher, one rank in this process: a (1, 1)
mesh). Every parameter becomes a DTensor placed by ``params_shardings``,
the batch by ``batch_spec``; rank 0 prints the lines and writes the
checkpoint (full tensors).

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --layers 1 --steps 8
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --reduced --device cpu --mesh debug
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import sharding, spmd
from repro_torch.launch.serve import DATA_VOCAB
from repro_torch.models import Model
from repro_torch.train.checkpoint import save
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.loop import make_train_step, to_batch
from repro_torch.train.optim import OptConfig, adamw_init


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-235b-a22b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", choices=["none", "debug"], default="none",
                    help="'debug' shards over a 1xN mesh of the ranks "
                         "(torch.distributed.run; one rank without it)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers")
    return ap.parse_args(argv)


def config(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def train(args, cfg, model: Optional[Model] = None) -> dict:
    """Train ``cfg`` for ``args.steps`` steps and print the reference's
    lines. ``model``: weights to train (default ``Model(cfg).init(0)`` on
    ``args.device``), the same on every rank. Under ``--mesh debug`` the
    model is placed (its parameters become DTensors) and the process
    group this call starts is stopped on return. -> {"model", "losses",
    "gnorms", "step_s": each step's wall seconds (its loss read ends
    it)}."""
    started = args.mesh == "debug" and spmd.start(args.device)
    if model is None:
        model = Model(cfg, device=args.device).init(0)
    if args.mesh == "debug":
        mesh = spmd.train_mesh()
        sharding.place(model, spmd.device_mesh(mesh, model.device.type),
                       mesh)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                        total_steps=args.steps)
    step = make_train_step(model, opt_cfg, remat=True)
    opt = adamw_init(dict(model.named_parameters()))
    data = TokenStream(DataConfig(vocab=min(cfg.vocab, DATA_VOCAB),
                                  seq_len=args.seq, batch=args.batch))
    losses, gnorms, step_s = [], [], []
    t0 = time.time()
    for i, batch in enumerate(data.batches(args.steps)):
        t_step = time.perf_counter()
        out = step(opt, to_batch(batch, model.device))
        # repro-lint: disable=host-sync -- loss/grad-norm logging at step boundaries is an accepted sync (the reference launcher's main fences it)
        loss, gn = (float(v) for v in out)
        step_s.append(time.perf_counter() - t_step)
        losses.append(loss)
        gnorms.append(gn)
        if rank0 and (i % max(1, args.steps // 10) == 0
                      or i == args.steps - 1):
            print(f"step {i:4d} loss {loss:.4f} gnorm {gn:.3f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    if args.ckpt:
        save(args.ckpt, model)
        if rank0:
            print(f"saved params to {args.ckpt}")
    if started:
        spmd.stop()
    return {"model": model, "losses": losses, "gnorms": gnorms,
            "step_s": step_s}


def main(argv=None):
    args = parse_args(argv)
    return train(args, config(args))


if __name__ == "__main__":
    main()
