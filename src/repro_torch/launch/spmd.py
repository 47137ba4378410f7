"""The sharded steps' process group, their kernel sites and their
collective counter.

The reference runs one controller over a ``jax.make_mesh`` and lets GSPMD
partition the jitted step. The port runs one process a device, as
``torch.distributed`` does: ``start`` joins the launcher's group (from
``torch.distributed.run``'s environment) or, with no launcher, starts a
group of one rank in this process; ``device_mesh`` lays a ``Mesh`` over
it. Parameters become ``DTensor``s placed by ``sharding.py``'s specs
(``sharding.place``), and DTensor's sharding propagation inserts the
collectives, as GSPMD does.

A hand-written kernel takes local tensors. ``site`` runs a function over
the local blocks of its DTensor arguments through ``local_map``: the
kernels run at local shapes (B1 over the expert dim, B4 over heads, B5
over channels), and so do the ops around them that DTensor has no
sharding rule for (the MoE dispatch's sort, scatter and ``index_add_``,
each model rank over its own experts' slots). It calls the function
directly when no argument is a DTensor, so an unplaced model runs the
same ops.

The serving steps write a decode cache placed by ``cache_shardings``:
``block_site`` runs each write over this rank's block of a cache entry
(its rows, heads or channels, and on a sequence-sharded cache only the
positions its block holds), so no cache is gathered to write a row; on
a sequence-sharded cache decode attention runs over each rank's block
and ``merge_blocks`` merges the blocks by their log-sum-exp.

``CollectiveCounter`` counts every ``_c10d_functional`` collective by the
reference's kinds, with its output bytes (``roofline.collective_bytes``'s
definition): the dry run records them over a fake group of the mesh's
size (``fake_group``).
"""
from __future__ import annotations

import contextlib
import math
import os
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import Mesh

# _c10d_functional op -> the reference's collective kind
KINDS = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         # DTensor's own op for a sharded-dim swap over NCCL
         "shard_dim_alltoall": "all-to-all"}
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def start(device) -> bool:
    """Join the default process group: from the launcher's environment
    when ``WORLD_SIZE`` is set (one rank a card on ``cuda``, ``cuda:
    LOCAL_RANK``), else a group of one rank in this process. NCCL on
    ``cuda``, gloo on ``cpu``. -> True when this call started it (the
    caller then calls ``stop``), False when a group was already up."""
    if dist.is_initialized():
        return False
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no process group on {kind!r}")
    backend = "nccl" if kind == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if kind == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"rank {local} needs a card of its own: "
                    f"{torch.cuda.device_count()} visible")
            torch.cuda.set_device(local)
        dist.init_process_group(backend)
    else:
        if kind == "cuda":
            torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def stop() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_group(world_size: int):
    """A process group of ``world_size`` ranks that moves nothing (rank 0
    of ``torch.testing``'s fake backend): the dry run places a meta model
    over it. Destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_mesh(mesh: Mesh, device_type: str) -> DeviceMesh:
    """``mesh``'s axes over the default group's ranks (row-major, as
    ``jax.make_mesh`` lays devices out)."""
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"mesh {mesh.sizes} needs {mesh.size} ranks, the "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, mesh.sizes,
                            mesh_dim_names=mesh.axis_names)


def train_mesh() -> Mesh:
    """The reference's ``--mesh debug``: (1, N) over ("data", "model"),
    N every rank of the group."""
    return Mesh(("data", "model"), (1, dist.get_world_size()))


def is_placed(*tensors) -> bool:
    return any(isinstance(t, DTensor) for t in tensors)


def axis_size(t, axis: str) -> int:
    """The ranks of mesh axis ``axis`` a DTensor lies over (1 for a plain
    tensor)."""
    if not isinstance(t, DTensor):
        return 1
    return t.device_mesh.size(t.device_mesh.mesh_dim_names.index(axis))


def sharded_on(t, dim: int) -> bool:
    """Is DTensor ``t`` sharded on tensor dim ``dim`` over some mesh dim
    of more than one rank? (False for a plain tensor.)"""
    return isinstance(t, DTensor) and any(
        p.is_shard(dim) and t.device_mesh.size(i) > 1
        for i, p in enumerate(t.placements))


def mesh_of(*tensors) -> DeviceMesh:
    return next(t.device_mesh for t in tensors if isinstance(t, DTensor))


def step_context(model):
    """The context a placed model's step runs in: plain tensors the model
    makes (positions, masks, zeros) count as replicated. A no-op for an
    unplaced model."""
    if any(isinstance(p, DTensor) for p in model.parameters()):
        return implicit_replication()
    return contextlib.nullcontext()


def on_mesh(t, mesh, placements):
    """``t`` as a DTensor with ``placements`` (a plain tensor is taken as
    replicated); Replicate -> Shard is a local slice, Partial -> Replicate
    an all-reduce."""
    if t is None or placements is None:
        return t
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(mesh, placements)
    return t


def site(fn, in_specs, out_specs, *args, grad_specs=None):
    """``fn(*args)`` over the local blocks of ``args`` when one of them is
    a DTensor, else ``fn(*args)``. A spec says how a tensor lies over the
    mesh: an int, the dim sharded over the ``model`` axis; a pair (that
    dim or None, the dim sharded over the batch axes or None); None,
    replicated (a non-tensor argument takes None). An axis of one rank
    replicates, and so do the batch axes when some argument's batch dim
    does not split over them (a batch of one row over two data ranks:
    context-parallel decode shards the cache's sequence instead).
    ``grad_specs``: per argument, ``"partial"`` in place of a dim where
    each rank's gradient is a partial sum (a replicated input read by
    every model shard, or by every batch shard), else the input's own
    spec."""
    if not is_placed(*args):
        return fn(*args)
    mesh = mesh_of(*args)
    names = mesh.mesh_dim_names
    rows = math.prod(mesh.size(i) for i, n in enumerate(names)
                     if n in ("pod", "data"))
    split = all(a.shape[s[1]] % rows == 0
                for a, s in zip(args, in_specs)
                if isinstance(a, torch.Tensor) and isinstance(s, tuple)
                and isinstance(s[1], int))

    def pl(spec):
        model, batch = spec if isinstance(spec, tuple) else (spec, None)
        if not split:
            batch = None
        out = [Replicate()] * mesh.ndim
        for i, name in enumerate(names):
            if mesh.size(i) == 1:
                continue
            if name == "model" and model == "partial":
                out[i] = Partial()
            elif name == "model" and model is not None:
                out[i] = Shard(model)
            elif name in ("pod", "data") and batch == "partial":
                out[i] = Partial()
            elif name in ("pod", "data") and batch is not None:
                out[i] = Shard(batch)
        return out

    tensor = [isinstance(a, torch.Tensor) for a in args]
    in_pl = tuple(pl(s) if is_t else None
                  for s, is_t in zip(in_specs, tensor))
    args = [on_mesh(a, mesh, p) for a, p in zip(args, in_pl)]
    grads = None
    if grad_specs is not None:
        grads = tuple(pl(g) if is_t else None
                      for g, is_t in zip(grad_specs, tensor))
    out_pl = tuple(pl(s) for s in out_specs)
    mapped = local_map(fn, out_pl if len(out_pl) > 1 else out_pl[0],
                       in_placements=in_pl, in_grad_placements=grads,
                       device_mesh=mesh)
    return mapped(*args)


def offset(t, dim: int) -> int:
    """The global index of this rank's first element of DTensor ``t``
    along ``dim`` (0 for a plain tensor, or a dim no mesh dim shards)."""
    if not isinstance(t, DTensor):
        return 0
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _, off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return off[dim]


def _following(buf, a, skip=None):
    """Placements of tensor ``a`` laid out as DTensor ``buf``: sharded as
    ``buf`` on each mesh dim that shards a dim ``a`` also has (its leading
    dims are ``buf``'s), except ``skip``; replicated elsewhere."""
    return [p if p.is_shard() and p.dim < a.dim() and p.dim != skip
            else Replicate() for p in buf.placements]


def block_site(fn, buf, *args, seq_dim=None):
    """A write into a cache entry, rank by rank: ``fn(buf, *args, off)``
    over the local blocks when ``buf`` is a DTensor, which returns this
    rank's new block (``buf``'s, written in place, or a tensor of its
    shape); ``fn(buf, *args, None)`` otherwise. ``off`` is the global index of the block's first
    position along ``seq_dim`` when a mesh dim shards it (the rank whose
    block holds a position writes it, the others keep theirs), else None
    (the block holds the whole sequence). Each tensor argument lies as
    ``buf`` does on the dims it shares with it (batch rows, heads,
    channels), and whole along ``seq_dim``: every rank holds the new rows;
    a plain one counts as replicated. -> ``buf``'s DTensor, its placements
    kept (nothing is gathered to write a row)."""
    if not isinstance(buf, DTensor):
        return fn(buf, *args, None)
    mesh = buf.device_mesh
    off = (offset(buf, seq_dim) if seq_dim is not None and any(
        p.is_shard(seq_dim) and mesh.size(i) > 1
        for i, p in enumerate(buf.placements)) else None)
    in_pl = (tuple(buf.placements),) + tuple(
        tuple(_following(buf, a, seq_dim)) if isinstance(a, torch.Tensor)
        else None for a in args) + (None,)
    args = [on_mesh(a, mesh, p) for a, p in zip((buf,) + args, in_pl)]
    mapped = local_map(fn, list(buf.placements), in_placements=in_pl,
                       device_mesh=mesh)
    return mapped(*args, off)


def merge_blocks(out, lse):
    """The softmax over a sequence sharded across ranks, from each rank's
    block: ``out`` (N, ..., hd), each block's normalised output, and
    ``lse`` (N, ...), its log-sum-exp (-inf where the block has no valid
    position), stacked on a dim 0 that the sequence's mesh dims shard.
    The merge is the reference's softmax over a sharded axis, as GSPMD
    partitions it: an all-reduce of the largest ``lse``, then of the sum
    of the weights exp(lse - max) and of the weighted outputs. A block
    with no valid position weighs 0 (no NaN). -> (..., hd) fp32."""
    M = reduced(lse.amax(0))
    w = torch.where(lse == -torch.inf, 0.0,
                    torch.exp(lse - torch.where(M == -torch.inf, 0.0, M)))
    num = reduced((w[..., None] * out.float()).sum(0))
    den = reduced(w.sum(0))[..., None]
    return num / torch.where(den == 0, 1.0, den)


def rows(t, device_mesh: DeviceMesh):
    """A plain tensor every rank holds whole as a DTensor over
    ``device_mesh``: its dim 0 (the batch's rows) split over the batch
    axes where it divides evenly, else replicated (no collective); a
    DTensor as it is."""
    if isinstance(t, DTensor) or not isinstance(t, torch.Tensor):
        return t
    names = device_mesh.mesh_dim_names
    n = math.prod(device_mesh.size(i) for i, a in enumerate(names)
                  if a in ("pod", "data"))
    pl = [Shard(0) if a in ("pod", "data") and device_mesh.size(i) > 1
          and t.dim() and t.shape[0] % n == 0 else Replicate()
          for i, a in enumerate(names)]
    return DTensor.from_local(local_block(t, pl, device_mesh), device_mesh,
                              pl, run_check=False)


def gather_positions(x, idx):
    """``torch.gather(x, 1, idx)``: positions ``idx`` (B, n, d) of each row
    of an activation x (B, S, d). On a placed x, over its local blocks
    with ``idx`` laid out as x's rows (and channels): a gather along a dim
    no mesh dim shards is local and linear, so a pending sum stays pending
    (DTensor's own gather may shard the gathered dim over two mesh dims,
    whose masked sums it then cannot reduce)."""
    if not isinstance(x, DTensor):
        return torch.gather(x, 1, idx)
    mesh = x.device_mesh
    xpl = [Replicate() if p.is_shard(1) else p for p in x.placements]
    ipl = [Replicate() if p.is_partial() else p for p in xpl]
    x, idx = on_mesh(x, mesh, xpl), on_mesh(idx, mesh, ipl)
    return local_map(lambda x, i: torch.gather(x, 1, i), xpl,
                     in_placements=(xpl, ipl), device_mesh=mesh)(x, idx)


def replicate_like(t, like):
    """Plain tensor ``t`` (every rank's same copy) as a replicated DTensor
    on ``like``'s mesh when ``like`` is a DTensor; else ``t``."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def project(eq: str, x, w):
    """``torch.einsum(eq, x, w)`` for an activation ``x`` (its dim 0 the
    batch's rows) and a weight ``w``. On a placed model whose ``w`` is
    sharded over the model axis, a site over ``w``'s local block:
    column-parallel where the sharded dim reaches the output (the output
    is sharded there, ``x``'s gradient partial), row-parallel where it is
    contracted (``x`` sharded on it, each rank's output a partial sum).
    ``w``'s gradient sums over the batch shards."""
    wdim = next((p.dim for i, p in enumerate(getattr(w, "placements", ()))
                 if p.is_shard() and w.device_mesh.size(i) > 1
                 and w.device_mesh.mesh_dim_names[i] == "model"), None)
    if wdim is None:
        return torch.einsum(eq, x, w)
    ins, out = eq.split("->")
    xs, ws = ins.split(",")
    axis = ws[wdim]

    def fn(x, w):
        return torch.einsum(eq, x, w)
    wspec = (wdim, None)
    if axis in out:
        return site(fn, ((None, 0), wspec), ((out.index(axis), 0),), x, w,
                    grad_specs=(("partial", 0), (wdim, "partial")))
    xspec = (xs.index(axis), 0)
    return site(fn, (xspec, wspec), (("partial", 0),), x, w,
                grad_specs=(xspec, (wdim, "partial")))


def gathered(t):
    """A DTensor gathered over the model axis (its other placements kept);
    anything else as it is."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    i = mesh.mesh_dim_names.index("model")
    if not t.placements[i].is_shard():
        return t
    pl = list(t.placements)
    pl[i] = Replicate()
    return t.redistribute(mesh, pl)


def reduced(t):
    """A DTensor's pending sums (``Partial`` placements) reduced now (an
    all-reduce); anything else as it is."""
    if not isinstance(t, DTensor) or not any(p.is_partial()
                                             for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


def local(t):
    """A replicated DTensor's local copy (integer routing decisions that
    leave the autograd graph); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    if not all(p.is_replicate() for p in t.placements):
        t = t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)
    return t.to_local()


def local_block(full, placements, mesh: DeviceMesh):
    """This rank's block of the full tensor ``full`` under ``placements``
    (even shards): what ``DTensor.from_local`` takes, with no collective."""
    coord = mesh.get_coordinate()
    out = full
    for i, p in enumerate(placements):
        if p.is_shard():
            k = mesh.size(i)
            n = full.shape[p.dim]
            if n % k:
                raise ValueError(f"dim {p.dim} of {tuple(full.shape)} does "
                                 f"not split over {k} ranks")
            out = out.narrow(p.dim, coord[i] * (n // k), n // k)
    return out


class CollectiveCounter(TorchDispatchMode):
    """Counts every ``_c10d_functional`` collective a region issues (and
    ``_dtensor.shard_dim_alltoall``, DTensor's all-to-all over NCCL):
    {kind: {"count", "bytes"}} with the reference's kinds and its
    definition of bytes (each collective's output, per device). DTensor
    ops pass through to DTensor's dispatch, so the collectives its
    redistributions issue are seen."""

    def __init__(self):
        super().__init__()
        self.counts = defaultdict(int)
        self.bytes = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("_c10d_functional", "_dtensor"):
            kind = KINDS.get(func._opname)
            if kind is not None:
                self.counts[kind] += 1
                outs = out if isinstance(out, (list, tuple)) else [out]
                self.bytes[kind] += sum(t.numel() * t.element_size()
                                        for t in outs)
        return out

    def record(self) -> dict:
        """The reference's format: every kind, zeros included."""
        return {k: {"count": self.counts[k], "bytes": self.bytes[k]}
                for k in COLLECTIVES}
