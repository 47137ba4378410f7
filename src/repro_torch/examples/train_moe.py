"""Train a small MoE LM on the synthetic Markov task mixture, checkpoint
it, and reload. Port of ``examples/train_moe.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_moe [--steps 200] \
        [--d-model 256] [--device cpu]

(This exercises the training substrate: AdamW, load-balance aux loss,
remat, checkpointing.) Runs on ``cuda`` unless ``--device cpu`` is given;
on the card the expert FFN's forward runs in the B1 kernel.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.train import OptConfig, train_loop
from repro_torch.train.checkpoint import restore, save
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.loop import to_batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--experts", type=int, default=4)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_moe_ckpt.npz"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("qwen3-moe-235b-a22b").reduced(
        n_layers=args.layers, d_model=args.d_model, n_experts=args.experts,
        vocab=512)
    model = Model(cfg, device=args.device).init(0)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.active_param_count()/1e6:.1f}M active)")
    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=128, batch=8,
                                  markov_temp=2.0))
    opt = OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    _, losses = train_loop(model, data.batches(args.steps), opt,
                           n_steps=args.steps, log_every=20)
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}")

    save(args.ckpt, model)
    restored = restore(args.ckpt, Model(cfg, device=args.device))
    batch = to_batch(next(iter(data.batches(1, seed=99))), model.device)
    with torch.no_grad():
        l1 = model.loss(batch)
        l2 = restored.loss(batch)
    print(f"checkpoint roundtrip: loss {float(l1):.4f} == {float(l2):.4f}")
    assert abs(float(l1) - float(l2)) < 1e-6
    return float(l1), float(l2)


if __name__ == "__main__":
    main()
