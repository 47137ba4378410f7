"""Load the reference package's parameter tree into the port's modules.

The tree is the one ``repro.models.Model.init`` returns, with every leaf
already converted to a numpy array (``jax.tree.map(np.asarray, params)``):
``embed``, ``final_norm``, ``lm_head``, ``pos_embed`` (learned positions),
``prefix`` (one dict per unrolled layer), ``blocks`` (one dict per
position in the layer period, every leaf stacked on a leading scan-group
axis) and, in an encoder-decoder, ``enc_pos_embed``, ``enc_final_norm``
and ``encoder`` (one dict of leaves stacked on a leading layer axis);
decoder blocks then carry ``norm_cross`` and ``cross_attn``. bfloat16 leaves
(``ml_dtypes.bfloat16``) pass through float32, which holds them exactly.
"""
from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _flatten(val, f"{prefix}{key}.")
    else:
        yield prefix[:-1], tree


def _to_tensor(arr, like: torch.Tensor) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr))          # a writable copy
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"shape {tuple(t.shape)} != {tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def reference_leaves(model, tree):
    """{port parameter name: the tree's array for it}: the reference's
    leaves with the scan-group and encoder axes unstacked (works for any
    tree of the parameters' structure, e.g. their gradients)."""
    out = {}

    def add(prefix, sub):
        for name, arr in _flatten(sub):
            out[prefix + name] = arr
    add("", {k: tree[k] for k in ("embed", "final_norm", "lm_head",
                                  "pos_embed", "enc_pos_embed",
                                  "enc_final_norm") if k in tree})
    for g in range(len(getattr(model, "encoder", ()))):
        add(f"encoder.{g}.", _index(tree["encoder"], g))
    for i in range(model.n_prefix):
        add(f"layers.{i}.", tree["prefix"][i])
    for pos, stacked in enumerate(tree["blocks"]):
        for g in range(model.n_groups):
            layer = model.n_prefix + g * model.period + pos
            add(f"layers.{layer}.", _index(stacked, g))
    return out


@torch.no_grad()
def from_reference(model, tree):
    """Copy ``tree`` into ``model`` (a ``repro_torch`` Model of the same
    config) and return the model."""
    for name, arr in reference_leaves(model, tree).items():
        param = model.get_parameter(name)
        param.copy_(_to_tensor(arr, param))
    return model


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]
