"""Launch-time cost analysis of a step traced over meta tensors.

The port's counterpart of the reference's ``launch/hlo_analysis.py``. The
reference compiles the step and parses the HLO text, walking ``while``
bodies by their trip counts; the port runs every layer eagerly, so a
``TorchDispatchMode`` sees each aten op once per execution and there is
no trip count to recover (``parse_module``, ``_trip_count`` and
``_fusion_bytes`` are replaced, not missing). Over meta tensors nothing
is computed and nothing is allocated, so a full-width step traces on any
host.

What ``CostMode`` counts while it is active:

- ``dot_flops``: the matrix products' FLOPs by ``torch.utils.flop_counter``'s
  rules (2·M·N·K for ``mm``/``bmm``/``addmm``/``baddbmm``, as
  ``hlo_analysis._dot_flops`` counts a ``dot``), plus each kernel
  stand-in's products (``kernels.meta``);
- ``bytes_accessed``: each op's tensor inputs read once and its outputs
  written once; views and empty allocations move nothing. A kernel call is
  one op at the bytes the kernel reads and writes, not its plain version's
  ops;
- ``peak_bytes``: the most bytes held at once by tensors the traced code
  created (arguments made before the trace are not counted). A storage is
  held while a Python reference to one of its tensors, or autograd's saved
  copy of one, is alive;
- ``kernels``: launches per kernel stand-in, and ``n_ops``.
"""
from __future__ import annotations

import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import meta

_EMPTY = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
          torch.ops.aten.empty_like, torch.ops.aten.new_empty,
          torch.ops.aten.new_empty_strided}
_INFO = {}


def _op_info(func):
    """-> (moves bytes, indices of the returns that are fresh tensors)."""
    info = _INFO.get(func)
    if info is None:
        rets = func._schema.returns
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in rets)
        fresh = tuple(i for i, r in enumerate(rets) if r.alias_info is None)
        info = _INFO[func] = (not view and func.overloadpacket not in _EMPTY,
                              fresh)
    return info


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Held:
    """A tensor autograd saved for the backward (kept as its Python
    object, so that its storage counts as held until the graph drops
    it)."""
    __slots__ = ("t", "__weakref__")

    def __init__(self, t):
        self.t = t


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes, peak held bytes and kernel launches of the
    code run under it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.bytes_accessed = 0.0
        self.n_ops = 0
        self.kernels = Counter()
        self.live = 0
        self.peak_bytes = 0
        self._size = {}
        self._owners = Counter()
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda held: held.t)

    def __enter__(self):
        meta.COUNTERS.append(self)
        self._hooks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        meta.COUNTERS.remove(self)
        self._hooks.__exit__(*exc)
        return super().__exit__(*exc)

    # -- held storage ---------------------------------------------------------
    def _own(self, obj, t):
        key = t.untyped_storage()._cdata
        if key not in self._size:
            return
        self._owners[key] += 1
        weakref.finalize(obj, self._release, key)

    def _release(self, key):
        self._owners[key] -= 1
        if not self._owners[key]:
            del self._owners[key]
            self.live -= self._size.pop(key)

    def _alloc(self, t):
        key = t.untyped_storage()._cdata
        if key in self._size:          # a fresh tensor never shares storage
            return
        self._size[key] = t.untyped_storage().nbytes()
        self.live += self._size[key]
        self.peak_bytes = max(self.peak_bytes, self.live)

    def _pack(self, t):
        held = _Held(t)
        self._own(held, t)
        return held

    # -- counting -------------------------------------------------------------
    def kernel(self, name, inputs, outputs, flops):
        """One launch of kernel ``name`` (a ``kernels.meta`` stand-in)."""
        self.kernels[name] += 1
        self.dot_flops += flops
        self.bytes_accessed += sum(map(nbytes, inputs)) \
            + sum(map(nbytes, outputs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.dot_flops += count(*args, **kwargs, out_val=out)
        moves, fresh = _op_info(func)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        if moves:
            self.bytes_accessed += sum(
                map(nbytes, _tensors((args, list(kwargs.values()))))) \
                + sum(map(nbytes, _tensors(outs)))
        for i, o in enumerate(outs):
            if isinstance(o, torch.Tensor):
                if i in fresh:
                    self._alloc(o)
                self._own(o, o)
        return out
