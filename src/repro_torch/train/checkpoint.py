"""Flat-npz checkpointing of a model's named parameters.

The port of ``repro.train.checkpoint``: one array per parameter, keyed by
its name in ``named_parameters()``. bfloat16 (which numpy lacks) is stored
as its raw 16 bits, and the reserved key ``BF16_KEY`` lists the arrays
that hold such bits. ``restore`` converts every array to its parameter's
dtype, as the reference's ``arr.astype(leaf.dtype)`` does: bf16 into bf16
comes back bit for bit, bf16 into fp32 exactly, fp32 into bf16 rounded to
nearest.

A placed model's parameters (DTensors) are saved as full tensors, gathered
on every rank and written by rank 0, and restored into each rank's
block."""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.launch.spmd import local_block

BF16_KEY = "__bf16__"


def save(path: str, model) -> None:
    """Write ``model``'s parameters to ``path``. Every rank of a placed
    model calls it (the full tensors are gathered); rank 0 writes."""
    flat, bf16 = {}, []
    for name, p in model.named_parameters():
        if isinstance(p, DTensor):
            p = p.full_tensor()
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
            bf16.append(name)
        flat[name] = t.numpy()
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
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
            if isinstance(p, DTensor):
                p.to_local().copy_(local_block(t, p.placements,
                                               p.device_mesh))
            else:
                p.copy_(t)
    return model
