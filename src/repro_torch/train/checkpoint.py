"""Flat-npz checkpointing of a model's named parameters.

The port of ``repro.train.checkpoint``: one array per parameter, keyed by
its name in ``named_parameters()``. bfloat16 (which numpy lacks) is stored
as its raw 16 bits, and the reserved key ``BF16_KEY`` lists the arrays
that hold such bits. ``restore`` converts every array to its parameter's
dtype, as the reference's ``arr.astype(leaf.dtype)`` does: bf16 into bf16
comes back bit for bit, bf16 into fp32 exactly, fp32 into bf16 rounded to
nearest."""
from __future__ import annotations

import os

import numpy as np
import torch

BF16_KEY = "__bf16__"


def save(path: str, model) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat, bf16 = {}, []
    for name, p in model.named_parameters():
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
            bf16.append(name)
        flat[name] = t.numpy()
    np.savez(path, **flat, **{BF16_KEY: np.asarray(bf16, dtype=str)})


@torch.no_grad()
def restore(path: str, model):
    """Copy the checkpoint at ``path`` into ``model``'s parameters (same
    names and shapes), each converted to its parameter's dtype and kept on
    its device. A checkpoint without ``BF16_KEY`` (written before the key
    existed) stored bf16, and nothing else, as int16. Returns model."""
    with np.load(path) as data:
        bits = (set(data[BF16_KEY].tolist()) if BF16_KEY in data.files
                else {n for n in data.files if data[n].dtype == np.int16})
        for name, p in model.named_parameters():
            arr = data[name]
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}: checkpoint shape {arr.shape}, "
                                 f"model {tuple(p.shape)}")
            t = torch.from_numpy(arr)
            if name in bits:
                t = t.view(torch.bfloat16)
            p.copy_(t)
    return model
