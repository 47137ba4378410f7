"""Flat-npz checkpointing of a model's named parameters.

The port of ``repro.train.checkpoint``: one array per parameter, keyed by
its name in ``named_parameters()``. bfloat16 (which numpy lacks) is stored
as its raw 16 bits and read back bit for bit."""
from __future__ import annotations

import os

import numpy as np
import torch


def save(path: str, model) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = {}
    for name, p in model.named_parameters():
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        flat[name] = t.numpy()
    np.savez(path, **flat)


@torch.no_grad()
def restore(path: str, model):
    """Copy the checkpoint at ``path`` into ``model``'s parameters (same
    names and shapes; each keeps its dtype and device). Returns model."""
    with np.load(path) as data:
        for name, p in model.named_parameters():
            arr = data[name]
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}: checkpoint shape {arr.shape}, "
                                 f"model {tuple(p.shape)}")
            t = torch.from_numpy(arr)
            if p.dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            p.copy_(t)
    return model
