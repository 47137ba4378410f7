"""Training launcher of the port: the same flags, defaults and printed
lines as ``repro.launch.train``, plus ``--device`` and ``--layers`` (a
depth cut, so that a full-width model fits one card).

Trains a ``repro_torch`` model (weights drawn from seed 0 on the device)
with AdamW on the synthetic Markov task mixture, remat on, and optionally
saves a checkpoint. The data draws from the first ``DATA_VOCAB`` ids at
most: its transition tables are quadratic in the vocabulary.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --layers 1 --steps 8
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

from repro_torch.configs import get_config
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
                    help="'debug' shards over a 1xN local mesh (waits for "
                         "torch.distributed)")
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
    ``args.device``). -> {"model", "losses", "gnorms"}."""
    if args.mesh == "debug":
        raise NotImplementedError(
            "--mesh debug needs a step sharded over torch.distributed "
            "(ROADMAP, expert parallelism); launch/sharding.py only sizes "
            "per-device shares for the dry run")
    if model is None:
        model = Model(cfg, device=args.device).init(0)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                        total_steps=args.steps)
    step = make_train_step(model, opt_cfg, remat=True)
    opt = adamw_init(dict(model.named_parameters()))
    data = TokenStream(DataConfig(vocab=min(cfg.vocab, DATA_VOCAB),
                                  seq_len=args.seq, batch=args.batch))
    losses, gnorms = [], []
    t0 = time.time()
    for i, batch in enumerate(data.batches(args.steps)):
        out = step(opt, to_batch(batch, model.device))
        # repro-lint: disable=host-sync -- loss/grad-norm logging at step boundaries is an accepted sync (the reference launcher's main fences it)
        loss, gn = (float(v) for v in out)
        losses.append(loss)
        gnorms.append(gn)
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {loss:.4f} gnorm {gn:.3f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    if args.ckpt:
        save(args.ckpt, model)
        print(f"saved params to {args.ckpt}")
    return {"model": model, "losses": losses, "gnorms": gnorms}


def main(argv=None):
    args = parse_args(argv)
    return train(args, config(args))


if __name__ == "__main__":
    main()
