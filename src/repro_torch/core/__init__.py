"""MoE-Infinity's contribution: activation-aware expert offloading.

- eam:       sequence-level expert activation tracing (EAM / EAMC, §4)
- tracer:    online per-sequence EAM maintenance from router outputs
- memsim:    multi-tier memory + link event simulator (SSD→DRAM→HBM)
- prefetch:  activation-aware expert prefetching (Algorithm 1, §5)
- cache:     activation-aware expert cache + baseline policies (Alg. 2, §6)
- offload:   OffloadEngine wiring the above into the serving runtime
"""
from repro_torch.core.eam import EAM, EAMC, eam_distance  # noqa: F401
from repro_torch.core.offload import OffloadEngine, OffloadConfig  # noqa: F401
