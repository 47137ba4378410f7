"""ServeSpec / TenantSpec / PredictorSpec — the structured serving
configuration surface (DESIGN.md §11).

``build_engine`` grew to 20 loose kwargs across nine PRs, and four of them
(``eamc_mode``/``eamc_path``/``predictor``/``predictor_path``) describe one
concept: which prediction brain serves, where its state persists, and
whether it learns online. This module collapses the surface into three
dataclasses:

* :class:`PredictorSpec` — one brain: ``kind`` (eamc | learned | hybrid),
  ``path`` (``.npz`` persistence; loaded at startup when present,
  rewritten at exit by the launcher), ``capacity`` (EAMC entry budget) and
  ``online`` (learn from served traffic).
* :class:`TenantSpec` — one tenant namespace: identity, SLA class
  (``interactive``/``standard``/``batch``), an optional *private*
  predictor (``predictor=None`` ⇒ the tenant shares the engine-wide
  brain), a per-tenant stall budget, an optional GPU-slot quota, and the
  workload shape (task ids + arrival-rate weight) the scenario generator
  consumes.
* :class:`ServeSpec` — the engine-level knobs shared by ``build_engine``
  (trace mode) and ``repro_torch.launch.serve`` (model mode), plus the tenant
  list.

All three round-trip through JSON (``--tenants spec.json``); ``from_dict``
is written field-by-field so the config-drift lint rule sees every field
as constructor-plumbed.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

SLA_CLASSES = ("interactive", "standard", "batch")


@dataclass
class PredictorSpec:
    """One prediction brain (DESIGN.md §10) as configuration: replaces the
    ``eamc_mode``/``eamc_path``/``predictor``/``predictor_path`` knob
    quartet. ``path`` is the brain's persisted state: the EAMC collection
    for ``kind="eamc"``, the learned model for ``learned``/``hybrid``.
    ``online=False, path=None`` is the offline oracle-peek construction
    (trace mode) / warmup pass (model mode); ``online=True`` cold-starts
    empty and learns from served traffic; a ``path`` that exists on disk
    warm-restarts from it (online learning stays on for eamc brains loaded
    from a path, matching the legacy ``eamc_mode="path"`` semantics)."""

    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    kind: str = "eamc"              # eamc | learned | hybrid
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    path: Optional[str] = None      # .npz persistence (None = not persisted)
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    capacity: int = 32              # EAMC entry budget
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    online: bool = False            # learn from served traffic

    def to_dict(self) -> dict:
        return {"kind": self.kind, "path": self.path,
                "capacity": self.capacity, "online": self.online}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PredictorSpec":
        if d is None:
            return cls()
        return cls(kind=d.get("kind", "eamc"),
                   path=d.get("path"),
                   capacity=int(d.get("capacity", 32)),
                   online=bool(d.get("online", False)))


@dataclass
class TenantSpec:
    """One tenant namespace. ``predictor=None`` means the tenant rides the
    engine-wide shared brain (no isolation); a :class:`PredictorSpec`
    gives it a private brain whose drift/reconstruction lifecycle never
    touches any other tenant's. ``shared_fallback`` lets a cold private
    brain (zero trained sequences) borrow the shared brain's predictions
    until its own has learned something."""

    tenant_id: str
    sla_class: str = "standard"     # interactive | standard | batch
    predictor: Optional[PredictorSpec] = None
    stall_budget: Optional[int] = None      # per-tenant admission budget
    gpu_slot_quota: Optional[int] = None    # max GPU cache slots owned
    shared_fallback: bool = True            # cold brain borrows shared preds
    tasks: Tuple[int, ...] = ()             # workload: task ids this tenant draws
    rps: float = 0.0                        # workload: arrival-rate weight

    def to_dict(self) -> dict:
        return {"tenant_id": self.tenant_id, "sla_class": self.sla_class,
                "predictor": (self.predictor.to_dict()
                              if self.predictor is not None else None),
                "stall_budget": self.stall_budget,
                "gpu_slot_quota": self.gpu_slot_quota,
                "shared_fallback": self.shared_fallback,
                "tasks": list(self.tasks), "rps": self.rps}

    @classmethod
    def from_dict(cls, d: dict) -> "TenantSpec":
        pd = d.get("predictor")
        return cls(tenant_id=str(d.get("tenant_id", "tenant")),
                   sla_class=d.get("sla_class", "standard"),
                   predictor=(PredictorSpec.from_dict(pd)
                              if pd is not None else None),
                   stall_budget=d.get("stall_budget"),
                   gpu_slot_quota=d.get("gpu_slot_quota"),
                   shared_fallback=bool(d.get("shared_fallback", True)),
                   tasks=tuple(int(t) for t in d.get("tasks", ())),
                   rps=float(d.get("rps", 0.0)))


@dataclass
class ServeSpec:
    """The one structured serving config: everything ``build_engine`` used
    to take as loose kwargs, plus the tenant list. Runtime *objects*
    (a prebuilt EAMC, a RoutingOracle, an HWConfig) stay ``build_engine``
    arguments
    — the spec is declarative and JSON-round-trippable."""

    arch: str = "switch-base-128"
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    system: str = "moe-infinity"     # benchmarks.common.SYSTEMS label
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    gpu_slots: Optional[int] = None
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    dram_slots: Optional[int] = None
    resident_fraction: Optional[float] = None
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    max_batch: int = 16
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    scheduling: str = "continuous"   # | static
    policy: str = "prefill"          # | decode | stall
    predictor: PredictorSpec = field(default_factory=PredictorSpec)
    tenants: Tuple[TenantSpec, ...] = ()
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    eamc_tasks: Optional[Tuple[int, ...]] = None  # offline peek task subset
    ssd_gbps: Optional[float] = None
    ssd_iops: Optional[float] = None
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    tier_aware: bool = True
    transfer_dtype: str = "fp32"
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    n_devices: int = 1
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    topk_all: bool = True
    # torch-lint: disable=config-drift -- set in the reference from benchmarks/ (build_engine in benchmarks/common.py and the spec benchmarks), which the port has not copied yet (ROADMAP §1 item 2)
    keep_request_eams: bool = False
    seed: int = 0

    def to_dict(self) -> dict:
        return {"arch": self.arch, "system": self.system,
                "gpu_slots": self.gpu_slots, "dram_slots": self.dram_slots,
                "resident_fraction": self.resident_fraction,
                "max_batch": self.max_batch, "scheduling": self.scheduling,
                "policy": self.policy,
                "predictor": self.predictor.to_dict(),
                "tenants": [t.to_dict() for t in self.tenants],
                "eamc_tasks": (list(self.eamc_tasks)
                               if self.eamc_tasks is not None else None),
                "ssd_gbps": self.ssd_gbps, "ssd_iops": self.ssd_iops,
                "tier_aware": self.tier_aware,
                "transfer_dtype": self.transfer_dtype,
                "n_devices": self.n_devices, "topk_all": self.topk_all,
                "keep_request_eams": self.keep_request_eams,
                "seed": self.seed}

    @classmethod
    def from_dict(cls, d: dict) -> "ServeSpec":
        et = d.get("eamc_tasks")
        return cls(arch=d.get("arch", "switch-base-128"),
                   system=d.get("system", "moe-infinity"),
                   gpu_slots=d.get("gpu_slots"),
                   dram_slots=d.get("dram_slots"),
                   resident_fraction=d.get("resident_fraction"),
                   max_batch=int(d.get("max_batch", 16)),
                   scheduling=d.get("scheduling", "continuous"),
                   policy=d.get("policy", "prefill"),
                   predictor=PredictorSpec.from_dict(d.get("predictor")),
                   tenants=tuple(TenantSpec.from_dict(t)
                                 for t in d.get("tenants", ())),
                   eamc_tasks=(tuple(int(t) for t in et)
                               if et is not None else None),
                   ssd_gbps=d.get("ssd_gbps"), ssd_iops=d.get("ssd_iops"),
                   tier_aware=bool(d.get("tier_aware", True)),
                   transfer_dtype=d.get("transfer_dtype", "fp32"),
                   n_devices=int(d.get("n_devices", 1)),
                   topk_all=bool(d.get("topk_all", True)),
                   keep_request_eams=bool(d.get("keep_request_eams", False)),
                   seed=int(d.get("seed", 0)))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1)

    @classmethod
    def from_json(cls, text: str) -> "ServeSpec":
        return cls.from_dict(json.loads(text))


def load_tenants(path: str) -> Tuple[TenantSpec, ...]:
    """Read a ``--tenants`` JSON file: either a bare list of tenant dicts
    or a ``{"tenants": [...]}`` document (a full ServeSpec file works)."""
    with open(path) as f:
        doc = json.load(f)
    items = doc.get("tenants", []) if isinstance(doc, dict) else doc
    return tuple(TenantSpec.from_dict(t) for t in items)
