"""PyTorch/CUDA port of the MoE-Infinity reproduction.

The JAX package ``repro`` is the reference; this package serves the same
models on an NVIDIA H100 through hand-written CUDA kernels. It imports
``torch`` and numpy only: the numpy host layer (configs, EAM/EAMC, offload
engine, memory simulator, scheduler) is kept as a verbatim copy whose
parity with the reference is checked by ``tests/test_torch_isolation.py``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU the kernels' plain PyTorch versions run instead. ``Model`` and
the launch-time analysis (``launch/dryrun.py``) also take
``device="meta"``: shapes without data, where each kernel is a stand-in
that counts its launch and computes nothing.
"""
from __future__ import annotations


def resolve_device(device="cuda") -> "torch.device":
    """The device an entry point runs on. Asking for CUDA on a machine
    without a usable GPU raises instead of silently running on the CPU.
    (``torch`` is imported here, not with the package, so that
    ``repro_torch.analysis`` runs before any dependency is importable.)"""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
