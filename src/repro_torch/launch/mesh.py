"""The reference's device meshes, as plain descriptions.

A mesh here is the axis names and sizes that the reference's
``launch/mesh.py`` builds: (16, 16) over ("data", "model") for one pod of
256 chips, (2, 16, 16) over ("pod", "data", "model") for two, and the
small debug meshes. It holds no devices and touches no process group: the
dry run (``launch/dryrun.py``) reads it to size each device's share of the
arguments (``launch/sharding.py``). Running over a real mesh of cards
waits for ``torch.distributed`` (ROADMAP, expert parallelism), as do the
reference's expert-parallel meshes (``expert=True``, ``make_expert_mesh``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple


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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (16, 16) over ("data", "model"). Multi-pod: (2, 16, 16)
    over ("pod", "data", "model"); the ``pod`` axis composes with ``data``
    for batch sharding."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_debug_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's reduced meshes for CI (8 or 16 devices)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 2, 4))
    return Mesh(("data", "model"), (2, 4))


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh, name: str) -> int:
    if name not in mesh.axis_names:
        return 1
    return mesh.shape[name]
