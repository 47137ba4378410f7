"""The reference's parameter, batch and cache sharding rules, written for
the port's parameter names, and the placement of a model by them.

The rules are the reference's (``launch/sharding.py``): name-based, with
divisibility checks and replication as the fallback (GQA head counts
smaller than the model axis, small LoRA ranks, norms); the stacked expert
dim of MoE weights shards over ``model`` (expert parallelism). A spec is a
tuple with one entry per dimension: None (replicated), an axis name, or a
tuple of axis names. The port unstacks every layer (``layers.<i>.``,
``encoder.<i>.``), so no spec has the reference's leading scan-group
entry. ``local_shape``/``local_bytes`` give one device's share.

``placements`` turns a spec into ``DTensor`` placements over a
``DeviceMesh`` (an entry naming a mesh axis is ``Shard(dim)`` on that
mesh dim, everything else, and a mesh dim of one rank, ``Replicate()``),
and ``place`` makes every
parameter of a model a DTensor laid out by its spec: the sharded training
step (``launch/train.py --mesh debug``) and the dry run's collectives
(``launch/dryrun.py``) run over it. ``place_cache`` lays a decode cache
out by ``cache_shardings`` for the placed serving steps.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.launch.mesh import Mesh, axis_size, batch_axes


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def param_spec(path: str, shape: tuple, mesh) -> tuple:
    """The spec of the parameter named ``path`` (as in
    ``named_parameters()``) of shape ``shape``."""
    m = axis_size(mesh, "model")
    body = tuple(shape)

    def last_dim(idx_out, idx_in=None):
        """Column-parallel on idx_out; fall back to row-parallel idx_in."""
        axes = [None] * len(body)
        if _div(body[idx_out], m):
            axes[idx_out] = "model"
        elif idx_in is not None and _div(body[idx_in], m):
            axes[idx_in] = "model"
        return tuple(axes)

    replicated = (None,) * len(body)
    name = path.split(".")[-1]
    # ---- embeddings / head -------------------------------------------------
    if name == "embed":
        return ("model", None) if _div(shape[0], m) else (None, None)
    if name == "lm_head":
        return (None, "model") if _div(shape[1], m) else (None, None)
    if name in ("pos_embed", "enc_pos_embed"):
        return (None, None)

    # ---- RWKV (names overlap attention; dispatch on path first) ------------
    if "rwkv" in path:
        if name in ("w_r", "w_k", "w_v", "w_g"):     # (d, d): column-parallel
            return last_dim(1)
        if name == "w_o":                            # (d, d): row-parallel
            return last_dim(0)
        if name == "u":                              # (H, hd)
            return last_dim(0, 1)
        if name == "cm_k":                           # (d, F)
            return last_dim(1)
        if name == "cm_v":                           # (F, d)
            return last_dim(0)
        return replicated

    # ---- MoE shared expert = dense FFN rules --------------------------------
    if "shared" in path:
        if name in ("w_gate", "w_up"):               # (d, f)
            return last_dim(1)
        if name == "w_down":                         # (f, d)
            return last_dim(0)
        return replicated

    # ---- MoE experts: expert-parallel on the stacked expert dim -------------
    if "moe" in path:
        if name in ("w_gate", "w_up", "w_down"):     # (E, d, f)
            axes = [None] * len(body)
            if _div(body[0], m):
                axes[0] = "model"
            return tuple(axes)
        return replicated                            # router etc.

    # ---- attention ----------------------------------------------------------
    if name in ("w_q", "w_k", "w_v") and len(body) == 3:   # (d, H, hd)
        return last_dim(1, 2)
    if name == "w_o" and len(body) == 3:                   # (H, hd, d)
        return last_dim(0, 1)
    if name in ("b_q", "b_k", "b_v"):                      # (H, hd)
        return last_dim(0, 1)
    if name in ("w_uq", "w_uk", "w_uv"):                   # (r, H, k) MLA
        return last_dim(1)
    if name in ("w_dq", "w_dkv", "w_kr"):
        return replicated

    # ---- dense FFN -----------------------------------------------------------
    if name in ("w_gate", "w_up"):                   # (d, f)
        return last_dim(1)
    if name == "w_down":                             # (f, d)
        return last_dim(0)

    # ---- mamba (shard the expanded inner dim) ---------------------------------
    if name == "w_in":                               # (d, 2*d_in)
        return last_dim(1)
    if name == "conv_w":                             # (conv, d_in)
        return last_dim(1)
    if name == "w_x_dbc":                            # (d_in, dtr+2N)
        return last_dim(0)
    if name == "w_dt":                               # (dtr, d_in)
        return last_dim(1)
    if name in ("dt_bias", "D"):                     # (d_in,)
        return last_dim(0)
    if name == "A_log":                              # (d_in, N)
        return last_dim(0)
    if name == "w_out":                              # (d_in, d)
        return last_dim(0)

    # ---- everything else (norms, scalars, LoRAs) -------------------------------
    return replicated


def params_shardings(params, mesh, *, mode: str = "auto") -> dict:
    """{name: spec} for ``params`` ({name: tensor}, e.g.
    ``dict(model.named_parameters())``). mode: "auto", the rules above;
    "dp_only", every parameter replicated (pure data parallelism)."""
    if mode == "dp_only":
        return {n: (None,) * p.dim() for n, p in params.items()}
    return {n: param_spec(n, tuple(p.shape), mesh) for n, p in params.items()}


def batch_spec(mesh) -> tuple:
    return (batch_axes(mesh),)


def cache_shardings(cache, mesh, cfg, *, shard_seq: bool) -> dict:
    """Specs of a decode cache (``Model.init_cache``'s structure: ``pos``
    and one dict per layer). ``shard_seq``: context-parallel mode for a
    batch smaller than the batch axes (the sequence dim over them)."""
    m = axis_size(mesh, "model")
    baxes = batch_axes(mesh)
    bsz = math.prod(axis_size(mesh, a) for a in baxes)

    def one(name, shape):
        spec = [None] * len(shape)
        if name == "pos" or not shape:
            return tuple(spec)
        if name in ("k", "v", "cross_k", "cross_v"):   # (B,S,kv,hd)
            if shard_seq and shape[0] < bsz:
                spec[1] = baxes
            elif _div(shape[0], bsz):
                spec[0] = baxes
            if _div(shape[2], m):
                spec[2] = "model"
            elif _div(shape[3], m):
                spec[3] = "model"
        elif name in ("ckv", "kr"):                    # (B,S,r)
            if shard_seq and shape[0] < bsz:
                spec[1] = baxes
            elif _div(shape[0], bsz):
                spec[0] = baxes
        elif name == "conv":                           # (B,c-1,d_in)
            if _div(shape[0], bsz):
                spec[0] = baxes
            if _div(shape[2], m):
                spec[2] = "model"
        elif name == "ssm":                            # (B,d_in,N)
            if _div(shape[0], bsz):
                spec[0] = baxes
            if _div(shape[1], m):
                spec[1] = "model"
        elif name == "state":                          # (B,H,K,V)
            if _div(shape[0], bsz):
                spec[0] = baxes
            if _div(shape[1], m):
                spec[1] = "model"
        elif name in ("tm", "cm"):                     # (B,d)
            if _div(shape[0], bsz):
                spec[0] = baxes
        return tuple(spec)

    return {"pos": one("pos", tuple(cache["pos"].shape)),
            "layers": [{k: one(k, tuple(t.shape)) for k, t in layer.items()}
                       for layer in cache["layers"]]}


def local_shape(shape, spec, mesh) -> tuple:
    """One device's block of a tensor of ``shape`` laid out by ``spec``."""
    out = []
    for n, axes in zip(shape, tuple(spec) + (None,) * len(shape)):
        if axes is None:
            out.append(n)
            continue
        names = (axes,) if isinstance(axes, str) else axes
        k = math.prod(axis_size(mesh, a) for a in names)
        out.append(-(-n // k))
    return tuple(out)


def local_bytes(t, spec, mesh) -> int:
    """Bytes of one device's block of tensor ``t`` laid out by ``spec``."""
    return math.prod(local_shape(tuple(t.shape), spec, mesh)) \
        * t.element_size()


def placements(spec, device_mesh) -> list:
    """``spec``'s ``DTensor`` placements over ``device_mesh`` (whose dim
    names are the spec's axis names): ``Shard(dim)`` on each mesh dim of
    more than one rank that a spec entry names, ``Replicate()`` on the
    others. A mesh axis named twice, or an axis the mesh lacks, raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = device_mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        for a in ((axes,) if isinstance(axes, str) else axes):
            if a not in names:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of "
                                 f"the mesh {names}")
            i = names.index(a)
            if out[i].is_shard():
                raise ValueError(f"spec {spec} shards two dims over {a!r}")
            # a mesh dim of one rank holds the whole tensor dim: Replicate
            # is the same block, and DTensor plans it far faster
            out[i] = Shard(dim) if device_mesh.size(i) > 1 else Replicate()
    return out


@torch.no_grad()
def place(model, device_mesh, mesh):
    """Make every parameter of ``model`` a DTensor over ``device_mesh``
    laid out by ``param_spec`` over ``mesh`` (the same axes): each rank
    keeps its block of the weights it holds (every rank must hold the
    same full weights; nothing is sent). A dim a spec shards that does not
    split evenly raises: nothing is replicated outside ``param_spec``'s
    own fallbacks. -> model."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.spmd import local_block
    for name in [n for n, _ in model.named_parameters()]:
        p = model.get_parameter(name)
        spec = param_spec(name, tuple(p.shape), mesh)
        pl = placements(spec, device_mesh)
        block = local_block(p.detach(), pl, device_mesh)
        if block.shape != p.shape:      # a copy, so the full one is freed
            block = block.clone()
        if tuple(block.shape) != local_shape(tuple(p.shape), spec, mesh):
            raise ValueError(f"{name}: block {tuple(block.shape)} is not "
                             f"the local shape of {spec}")
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, attr, nn.Parameter(
            DTensor.from_local(block, device_mesh, pl, run_check=False),
            requires_grad=p.requires_grad))
    return model


@torch.no_grad()
def place_cache(cache, device_mesh, mesh, cfg, shard_seq: bool) -> dict:
    """A decode cache (``Model.init_cache``'s structure, as every rank
    holds it) as DTensors over ``device_mesh``, each entry laid out by
    ``cache_shardings(cache, mesh, cfg, shard_seq=shard_seq)``: each rank
    keeps its block of rows, sequence positions, heads or channels
    (nothing is sent). ``pos`` is replicated. A dim the spec shards that
    does not split evenly raises, as in ``place``; an entry the specs do
    not name raises. -> the placed cache (a new dict; the blocks are
    copies, so the full tensors can be freed)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.spmd import local_block
    specs = cache_shardings(cache, mesh, cfg, shard_seq=shard_seq)

    def one(t, spec):
        if spec is None:
            raise ValueError(f"no sharding spec for a cache entry of shape "
                             f"{tuple(t.shape)}")
        pl = placements(spec, device_mesh)
        block = local_block(t, pl, device_mesh)
        if tuple(block.shape) != local_shape(tuple(t.shape), spec, mesh):
            raise ValueError(f"cache block {tuple(block.shape)} is not the "
                             f"local shape of {spec}")
        return DTensor.from_local(block.clone(), device_mesh, pl,
                                  run_check=False)

    layers = []
    for layer, lspec in zip(cache["layers"], specs["layers"]):
        if set(layer) != set(lspec):
            raise ValueError(f"cache entries {sorted(layer)} have no specs "
                             f"{sorted(set(layer) - set(lspec))}")
        layers.append({k: one(t, lspec[k]) for k, t in layer.items()})
    return {"pos": one(cache["pos"], specs["pos"]), "layers": layers}


def place_batch(batch, device_mesh) -> dict:
    """``batch`` ({name: tensor}, as every rank holds it) as DTensors laid
    out by ``batch_spec`` over ``device_mesh`` (M-RoPE's (3, B, S)
    ``positions`` on their second dim)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.spmd import local_block
    mesh = Mesh(device_mesh.mesh_dim_names, tuple(device_mesh.shape))
    out = {}
    for k, t in batch.items():
        spec = ((None,) + batch_spec(mesh) if k == "positions"
                else batch_spec(mesh))
        pl = placements(spec, device_mesh)
        out[k] = DTensor.from_local(local_block(t, pl, device_mesh),
                                    device_mesh, pl, run_check=False)
    return out
