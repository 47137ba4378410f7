"""repro_torch.analysis — PyTorch-aware static invariant checks of the port.

The port's counterpart of ``repro.analysis`` (DESIGN.md §9): a linter that
uses only the standard library, so that it runs before any dependency can
be imported. Every speed claim of the port rests on invariants that its
runtime tests exercise only on small configs; this package checks them
across ``src/repro_torch`` on every push:

* a rule registry (:mod:`repro_torch.analysis.rules`) with per-rule
  findings carrying file:line + fix hints;
* an inline-suppression syntax, ``# torch-lint: disable=<rule> -- reason``
  (the reason is mandatory; the prefix is not the reference's
  ``repro-lint``, so that the reference's linter, which also lints this
  tree, and the port's each read only their own directives);
* a baseline file (``analysis/baseline.json``), ported and tested, and
  kept empty: every sanctioned finding is a declared fence or step entry,
  or a directive with its reason;
* a device-boundary call graph (:mod:`~repro_torch.analysis.callgraph`:
  the declared CUDA-graph step entries and what they reach, the kernel
  launch sites, the autograd Functions), emitted as JSON by
  ``--capture-map``;
* a CLI: ``python -m repro_torch.analysis.lint [--json R] [--capture-map
  M] [--select r] [--list-rules] [paths]``.

What each of the reference's five rules became, and why:

* R1 ``recompile-hazard`` -> ``capture-hazard``. Eager PyTorch never
  recompiles; what a trace would bake in is what a CUDA-graph capture of a
  declared step entry would freeze or break on: host syncs (fences
  included), data-dependent shapes, host data copied onto the card, and
  R1's captured mutable closures.
* R2 ``donation-aliasing`` -> ``staging-reuse``. PyTorch has no donation;
  the buffer hazard of the streaming path is a page-locked host row
  written again while a ``non_blocking`` copy from it may be in flight.
* R3 ``host-sync`` -> ``host-sync``, with taint from ``torch`` calls,
  tensor methods and functions that return tensors, and the port's own
  ``DECLARED_FENCES`` (each mapped to a reference fence).
* R4 ``pallas-purity`` -> ``kernel-launch``. The port's kernels are CUDA
  C++, whose bodies no AST sees; the rule checks the Python launch
  wrappers' discipline (error code checked, no ``try``, no gradient,
  launches counted) and that plain versions and meta stand-ins run only
  on their own device branch.
* R5 ``config-drift`` -> ``config-drift``, the reference's rule
  unchanged, over the port's own config surface and launchers.

None of the reference's rules is left without a counterpart. The
reference's ``--jit-map`` became ``--capture-map``.
"""
from repro_torch.analysis.findings import Finding            # noqa: F401
