"""The reference's device meshes: plain descriptions for the dry run, and
the expert mesh that expert-parallel serving runs over.

A :class:`Mesh` is the axis names and sizes that the reference's
``launch/mesh.py`` builds: (16, 16) over ("data", "model") for one pod of
256 chips, (2, 16, 16) over ("pod", "data", "model") for two, the small
debug meshes, and with ``expert=True`` the same chip counts with the model
axis split into ("model", "expert"). It holds no devices and touches no
process group: the dry run (``launch/dryrun.py``) reads it to size each
device's share of the arguments (``launch/sharding.py``) and to lay a
``DeviceMesh`` over a group of its size.

An :class:`ExpertMesh` is the 1-D ("expert",) serving mesh of
``make_expert_mesh``, over an explicit tuple of ``torch.device``s. The
reference drives it from one controller (one offload engine, one placement,
D slot caches); so does the port: one process holds the D shard devices
and the expert exchange is block copies between them
(``kernels.moe_ffn.moe_ffn_sharded``). On the CPU its shards are logical,
the counterpart of the forced host devices the reference's launcher sets
up. Meshes of processes, one a device, are ``torch.distributed``
``DeviceMesh``es laid over a ``Mesh`` by ``launch/spmd.py::device_mesh``:
the sharded training step (``launch/train.py --mesh debug``) and the dry
run's collectives (over a fake group of the mesh's size).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.sizes)


class ExpertMesh:
    """1-D ("expert",) mesh over ``devices``, shard i on ``devices[i]``.
    Any device tuple is accepted, one device repeated included (D shards
    sharing one card or the CPU)."""

    axis_names = ("expert",)

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("an expert mesh needs at least one device")

    @property
    def shape(self) -> Dict[str, int]:
        return {"expert": len(self.devices)}

    def __repr__(self) -> str:
        return f"ExpertMesh({', '.join(map(str, self.devices))})"


def make_production_mesh(*, multi_pod: bool = False,
                         expert: bool = False) -> Mesh:
    """Single pod: (16, 16) over ("data", "model"). Multi-pod: (2, 16, 16)
    over ("pod", "data", "model"); the ``pod`` axis composes with ``data``
    for batch sharding. ``expert=True`` splits the model axis into
    ("model", "expert") at the same chip count."""
    if multi_pod:
        if expert:
            return Mesh(("pod", "data", "model", "expert"), (2, 16, 4, 4))
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    if expert:
        return Mesh(("data", "model", "expert"), (16, 4, 4))
    return Mesh(("data", "model"), (16, 16))


def make_debug_mesh(*, multi_pod: bool = False,
                    expert: bool = False) -> Mesh:
    """The reference's reduced meshes for CI (8 or 16 devices)."""
    if multi_pod:
        if expert:
            return Mesh(("pod", "data", "model", "expert"), (2, 2, 2, 2))
        return Mesh(("pod", "data", "model"), (2, 2, 4))
    if expert:
        return Mesh(("data", "model", "expert"), (2, 2, 2))
    return Mesh(("data", "model"), (2, 4))


def make_expert_mesh(n_devices: int | None = None,
                     device="cuda") -> ExpertMesh:
    """1-D ("expert",) serving mesh of ``n_devices`` shards. On ``cuda``:
    the first ``n_devices`` distinct cards (default all of them); fewer
    cards than asked for raises. On ``cpu``: ``n_devices`` logical shards
    of the CPU (default 1)."""
    kind = torch.device(device).type
    if kind == "cuda":
        avail = torch.cuda.device_count()
        d = avail if n_devices is None else int(n_devices)
    elif kind == "cpu":
        d = 1 if n_devices is None else int(n_devices)
        avail = max(d, 1)
    else:
        raise ValueError(f"make_expert_mesh: no expert mesh on {kind!r}")
    if d < 1 or d > avail:
        raise ValueError(
            f"make_expert_mesh: need 1 <= n_devices <= {avail} "
            f"available devices, got {n_devices}")
    if kind == "cpu":
        return ExpertMesh([torch.device("cpu")] * d)
    return ExpertMesh(torch.device("cuda", i) for i in range(d))


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh, name: str) -> int:
    if name not in mesh.axis_names:
        return 1
    return mesh.shape[name]
