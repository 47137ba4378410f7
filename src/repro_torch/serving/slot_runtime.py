"""Layered streaming execution for model-mode serving with the expert slot
cache (port of ``repro.serving.slot_runtime.SlotStreamRuntime``).

The fused slot-pool step needs every expert the iteration might touch on
the device before it starts, which cannot be known: layer ``l``'s router
runs on what layer ``l-1`` produced. This runtime walks the stack one layer
at a time with the block split at the MoE boundary:

    pre   norm -> attention or mamba decode (or prefill) -> norm -> router
          top-k
    host  read the routed expert ids (the one declared device->host sync
          of a layer: it waits on the compute stream only) and ``ensure``
          them in the slot cache (misses = timed demand uploads, victims =
          the engine's Algorithm-2 verdict)
    post  capacity dispatch over the slot buffers
          (``moe_ffn(routing=..., slot_weights=..., slot_ids=...)``)

so only one layer's routed experts must be resident at use time (the
capacity floor is ``E``, not ``L*E``).

Double-buffered schedule (default): ``sync_residency`` applies the
engine's evictions, stages the first MoE layer's uploads and files the
rest in a per-layer plan; the walk stages layer ``li+1``'s planned uploads
right after enqueueing layer ``li``'s ``post``, so their host->device
copies on the copy stream run while ``post`` computes. ``commit`` lands
staged rows in the slot buffers on the compute stream right before the
next ``post``. ``fenced=True`` stages everything at the boundary and waits
for the copy stream on every demand miss.

Spans (``serving.telemetry``): each MoE layer's wait for its routed ids
(``slot.route_wait``), the staging of the next layer's plan
(``slot.stage``), the step's final read-back (``step.readback``) and, on
CUDA, the device time of its commits (``slot.commit``).

PyTorch runs eagerly, so there is nothing to trace and ``compile_counts``
stays empty. On the CPU the same walk runs the kernels' plain versions and
the numbers equal the fused path's bit for bit at the fp32 wire.

Expert parallelism (:class:`ShardedSlotRuntime`): one slot cache per device
of an ``ExpertMesh``, residency split by the placement policy's home
device, and each MoE ``post`` running the expert FFN shard by shard
(``kernels.moe_ffn.moe_ffn_sharded_slots``) through ``moe_ffn``'s
``expert_fn`` seam. One process drives every shard, as the reference's
single controller does.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.slot_cache import ExpertSlotCache, HostExpertStore
from repro_torch.serving import telemetry
from repro_torch.kernels.moe_ffn import moe_ffn_sharded_slots
from repro_torch.models.moe import route, slot_out_dtype


class SlotStreamRuntime:
    """Per-layer prefill/decode over a pooled decode cache, streaming
    expert weights through an :class:`ExpertSlotCache`. Constructing it
    moves ``model``'s experts into the host store."""

    def __init__(self, model, *, n_pool_slots: int, n_weight_slots: int,
                 victim_fn=None, transfer_dtype: str = "fp32",
                 fenced: bool = False):
        if model.cfg.moe_dispatch == "grouped":
            raise NotImplementedError(
                "slot-cache streaming requires global dispatch "
                "(moe_dispatch='grouped' runs the expert FFN over every "
                "row's (E, C) blocks at once, which the slot table's "
                "per-layer walk does not take); serve it all-resident")
        if model.cfg.is_encoder_decoder:
            raise NotImplementedError(
                "slot-cache streaming does not support encoder-decoder "
                "models; run them all-resident (resident_fraction=1.0)")
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.store = HostExpertStore(model, transfer_dtype=transfer_dtype)
        self._init_slot_caches(n_weight_slots, fenced)
        self.fenced = bool(fenced)
        self._upload_plan: Dict[int, List] = {}
        self.victim_fn = victim_fn
        self.n_pool_slots = n_pool_slots
        self.cache_len: Optional[int] = None
        self.pos = np.zeros(n_pool_slots, np.int32)
        self.layer_caches: List = []
        self._moe_li = {idx: li for li, idx in enumerate(model.moe_layers)}
        # per-layer host rows of the slot table, page-locked on a GPU so
        # the upload of a row never blocks the host
        self._rows = torch.zeros(
            (len(model.moe_layers), self.store.n_experts), dtype=torch.int32,
            pin_memory=self.device.type == "cuda")

    def _init_slot_caches(self, n_weight_slots: int, fenced: bool) -> None:
        """One slot cache on the model's device (the sharded runtime
        overrides this with one cache per mesh device): ``slot_cache``,
        and ``slot_caches``, the list of the caches."""
        self.slot_cache = ExpertSlotCache(self.store, n_weight_slots,
                                          fenced=fenced)
        self.slot_caches = [self.slot_cache]

    def _note_commit_ms(self) -> None:
        """Record the device ms of the step's commits (``slot.commit``),
        once its read-back has waited for them; CUDA only."""
        ms = [c.commit_ms() for c in self.slot_caches]
        if None not in ms:
            telemetry.note("slot.commit", device_ms=sum(ms))

    # -- pool lifecycle ------------------------------------------------------
    def build_pool(self, cache_len: int) -> None:
        """(Re)build the pooled per-layer decode caches."""
        self.cache_len = cache_len
        self.layer_caches = self.model.init_cache(self.n_pool_slots,
                                                  cache_len)["layers"]
        self.pos = np.zeros(self.n_pool_slots, np.int32)

    def sync_residency(self, target_keys) -> int:
        """Iteration-boundary reconciliation: the OffloadEngine's GPU-cache
        verdicts become real async uploads and slot releases.

        Double-buffered mode: evictions apply now, the first MoE layer's
        uploads are staged now, and the remaining uploads are planned per
        layer (:meth:`_stage_plan`). Fenced mode stages everything now."""
        if self.fenced:
            return self.slot_cache.sync(target_keys)
        sc = self.slot_cache
        target = set(target_keys)
        for key in sc.resident:
            if key not in target:
                sc.evict(key)
        plan: Dict[int, List] = {}
        for key in sorted(target):
            if key not in sc:
                plan.setdefault(key[0], []).append(key)
        self._upload_plan = plan
        return self._stage_plan(0)

    def _stage_plan(self, li: int) -> int:
        """Stage the planned prefetch-class uploads for MoE layer ``li``
        (issued while the previous layer's ``post`` computes)."""
        keys = self._upload_plan.pop(li, None)
        if not keys:
            return 0
        return self.slot_cache.prefetch(keys)

    def flush_pending(self) -> None:
        """Stage any still-planned uploads and commit the staging set:
        residency then exactly matches the last sync's verdicts."""
        for li in sorted(self._upload_plan):
            self.slot_cache.prefetch(self._upload_plan[li])
        self._upload_plan.clear()
        self.slot_cache.commit()

    # -- per-layer pieces ----------------------------------------------------
    def _is_moe(self, i: int) -> bool:
        return i in self._moe_li

    def _ensure(self, li: int, expert_ids) -> None:
        self.slot_cache.ensure([(li, int(e)) for e in expert_ids],
                               self.victim_fn)

    def _route(self, p, h2):
        B, S, d = h2.shape
        gates, idx, _ = route(p.moe, self.cfg.moe, h2.reshape(B * S, d))
        return gates, idx

    def _slot_args(self, li: int):
        """The slot table row of MoE layer ``li`` on the device and the
        committed slot buffers (staged uploads land now, after everything
        already enqueued that reads the old contents)."""
        self._rows[li] = torch.from_numpy(self.slot_cache.table_row(li))
        row = self._rows[li].to(self.device, non_blocking=True)
        return self.slot_cache.commit(), row

    def _run_decode_post(self, desc, li, p, x_mid, h2, gates, idx):
        """Enqueue one MoE layer's decode ``post`` against the freshly
        committed slot buffers (the sharded runtime overrides this with the
        expert-parallel exchange)."""
        bufs, row = self._slot_args(li)
        return self.model._decode_block_post(
            p, desc, x_mid, h2, routing=(gates, idx), slot_weights=bufs,
            slot_ids=row)

    def _run_prefill_post(self, desc, li, p, x_mid, h2, gates, idx,
                          token_mask):
        bufs, row = self._slot_args(li)
        return self.model._apply_block_post(
            p, desc, x_mid, h2, capacity_factor=2.0, token_mask=token_mask,
            routing=(gates, idx), slot_weights=bufs, slot_ids=row)

    # -- decode --------------------------------------------------------------
    @torch.inference_mode()
    def decode(self, tok_np: np.ndarray, active_np: np.ndarray):
        """One pooled decode step. Returns (new tokens (B,) np, counts
        (n_moe, B, E) np, inactive rows zeroed as in the fused step)."""
        model, dev = self.model, self.device
        tok = torch.from_numpy(np.asarray(tok_np)).to(dev, torch.long)
        pos = torch.from_numpy(self.pos).to(dev)
        active = torch.from_numpy(np.asarray(active_np, bool)).to(dev)
        rows = np.asarray(active_np, bool)
        x = model._embed_step(tok, pos)
        counts_rows = []
        for i, (p, desc) in enumerate(zip(model.layers, model.descs)):
            bc = self.layer_caches[i]
            x_mid, h2, bc = model._decode_block_pre(p, desc, bc, x, pos,
                                                    active=active)
            if not self._is_moe(i):
                x, _ = model._decode_block_post(p, desc, x_mid, h2)
                continue
            li = self._moe_li[i]
            gates, idx = self._route(p, h2)
            with telemetry.Span("slot.route_wait"):
                idx_np = idx.cpu().numpy()             # (B*1, k): sync point
            used = (np.unique(idx_np[rows]) if rows.any()
                    else np.empty(0, np.int64))
            self._ensure(li, used)
            x, cnts = self._run_decode_post(desc, li, p, x_mid, h2, gates,
                                            idx)
            # double-buffered overlap: issue the next MoE layer's planned
            # uploads while this post computes
            with telemetry.Span("slot.stage"):
                self._stage_plan(li + 1)
            counts_rows.append(cnts * active.to(cnts.dtype)[:, None])
        logits = model._logits(model.final_norm(x))[:, 0]
        with telemetry.Span("step.readback"):
            tok_new = torch.argmax(logits, dim=-1).cpu().numpy()
            counts = torch.stack(counts_rows).cpu().numpy()
        self._note_commit_ms()
        self.pos = self.pos + rows.astype(np.int32)
        return tok_new, counts

    # -- prefill -------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, padded_prompt: np.ndarray, true_len: int, slot: int):
        """Stream one right-padded B=1 prompt through the stack and land
        its per-layer caches in pool row ``slot``. Returns (first generated
        token, counts (n_moe, E) np, pad tokens excluded)."""
        model, dev = self.model, self.device
        P = len(padded_prompt)
        toks = torch.from_numpy(
            np.asarray(padded_prompt, np.int64)[None]).to(dev)
        tl = torch.tensor([true_len], dtype=torch.int32, device=dev)
        token_mask = torch.arange(P, device=dev)[None, :] < tl[:, None]
        x, positions = model._embed({"tokens": toks})
        counts_rows = []
        for i, (p, desc) in enumerate(zip(model.layers, model.descs)):
            x_mid, h2, aux = model._apply_block_pre(p, desc, x, positions)
            bc = self.layer_caches[i]
            for key in bc:
                bc[key][slot].zero_()
            model._seed_mixer(bc, desc, aux, rows=slice(slot, slot + 1))
            if not self._is_moe(i):
                x, _ = model._apply_block_post(p, desc, x_mid, h2,
                                               capacity_factor=2.0,
                                               token_mask=token_mask)
                continue
            li = self._moe_li[i]
            gates, idx = self._route(p, h2)
            with telemetry.Span("slot.route_wait"):
                idx_np = idx.cpu().numpy()[:true_len]  # real tokens only
            self._ensure(li, np.unique(idx_np))
            x, aux2 = self._run_prefill_post(desc, li, p, x_mid, h2, gates,
                                             idx, token_mask)
            with telemetry.Span("slot.stage"):
                self._stage_plan(li + 1)
            counts_rows.append(aux2["counts"][0])
        last = (tl.long() - 1)[:, None, None].expand(1, 1, x.shape[-1])
        x_last = torch.gather(x, 1, last)
        logits = model._logits(model.final_norm(x_last))[:, 0]
        with telemetry.Span("step.readback"):
            tok0 = int(torch.argmax(logits[0]))
            counts = torch.stack(counts_rows).cpu().numpy()
        self._note_commit_ms()
        self.pos[slot] = true_len
        return tok0, counts


# ---------------------------------------------------------------------------
# Expert-parallel sharded runtime
# ---------------------------------------------------------------------------


class _CacheGroupView:
    """Aggregate view over the per-device slot caches: summed counters for
    the engine's stats crosswalk, plus the union residency view the
    consistency checks read. Not a cache: movement goes through the
    per-device instances."""

    def __init__(self, caches):
        self.caches = caches

    @property
    def n_slots(self) -> int:
        return sum(c.n_slots for c in self.caches)

    @property
    def resident(self):
        return [k for c in self.caches for k in c.resident]

    def __contains__(self, key) -> bool:
        return any(key in c for c in self.caches)

    def stats(self) -> dict:
        per_dev = [c.stats() for c in self.caches]
        agg = dict(per_dev[0])
        for s in per_dev[1:]:
            for k, v in s.items():
                if isinstance(v, (int, float)):
                    agg[k] = agg[k] + v
        # non-additive fields: identical across devices, keep one copy
        agg["transfer_dtype"] = per_dev[0]["transfer_dtype"]
        agg["wire_expert_bytes"] = per_dev[0]["wire_expert_bytes"]
        agg["n_devices"] = len(per_dev)
        agg["per_device"] = per_dev
        return agg


class ShardedSlotRuntime(SlotStreamRuntime):
    """Expert-parallel serving over a 1-D ("expert",) ``ExpertMesh``
    (port of ``repro.serving.slot_runtime.ShardedSlotRuntime``).

    The same per-layer walk as :class:`SlotStreamRuntime`, with:

    * per-device slot caches: one :class:`ExpertSlotCache` on each mesh
      device, each with its own copy stream, so D host->device upload
      streams run at once; residency is partitioned by the placement
      policy's home assignment (the OffloadEngine's global Algorithm-2
      verdicts still decide what is resident);
    * sharded expert compute: each MoE ``post`` hands ``moe_ffn`` an
      ``expert_fn`` that puts the dispatched (E, C, d) blocks in placement
      order (``perm``: position p holds expert ``perm[p]``, shard i owns
      positions [i cap, (i+1) cap)), runs
      :func:`~repro_torch.kernels.moe_ffn.moe_ffn_sharded_slots` (each
      shard's slot kernel over its own buffers and its (cap,) row of home
      experts' slots) and restores expert order (``inv_perm``);
    * one controller: the routers, attention and the pooled decode cache
      stay on the model's device and run there once. The reference commits
      them replicated to every mesh device and runs each per-layer jit
      SPMD, which computes the same values D times. Replicated values, an
      exchange that is an exact permutation and a local FFN that splits no
      contraction dim give the D = 1 tokens bit for bit in both.

    A placement rebalance changes only ``perm``, ``inv_perm`` and the slot
    rows, which are uploaded with each layer.
    """

    def __init__(self, model, *, mesh, placement, **kw):
        if model.cfg.moe_dispatch == "grouped":
            raise NotImplementedError(
                "expert-parallel serving requires global dispatch "
                "(moe_dispatch='grouped' runs the expert FFN once a "
                "sequence, which the sharded slot exchange does not take)")
        D = mesh.shape["expert"]
        E = model.cfg.moe.n_experts
        if E % D != 0:
            raise ValueError(f"n_experts {E} must divide by the "
                             f"expert-parallel degree {D}")
        self.mesh = mesh
        self.placement = placement
        super().__init__(model, **kw)
        # per-layer host rows (perm, inv_perm, the slot of the expert at
        # each position on its home shard), page-locked on a GPU
        self._perm_rows = torch.zeros(
            (len(model.moe_layers), 3, E), dtype=torch.int32,
            pin_memory=self.device.type == "cuda")

    def _init_slot_caches(self, n_weight_slots: int, fenced: bool) -> None:
        devices = self.mesh.devices
        D = len(devices)
        # every device must at least hold one layer's worst-case routed
        # slice of its own homes (cap = E/D experts)
        per_dev = max(n_weight_slots // D, self.placement.cap)
        self.slot_caches = [
            ExpertSlotCache(self.store, per_dev, fenced=fenced, device=dev)
            for dev in devices]
        self.slot_cache = _CacheGroupView(self.slot_caches)

    def _partition_targets(self, target_keys):
        """Split a global residency target by placement home, trimmed to
        each device's capacity (already-resident keys keep their slots
        first: minimal churn under a home flip)."""
        targets = [set() for _ in self.slot_caches]
        for key in target_keys:
            targets[self.placement.device_of(*key)].add(key)
        out = []
        for cache, tgt in zip(self.slot_caches, targets):
            if len(tgt) > cache.n_slots:
                keep = sorted(k for k in tgt if k in cache)
                rest = sorted(k for k in tgt if k not in cache)
                tgt = set((keep + rest)[: cache.n_slots])
            out.append(tgt)
        return out

    def sync_residency(self, target_keys) -> int:
        targets = self._partition_targets(target_keys)
        if self.fenced:
            return sum(c.sync(t)
                       for c, t in zip(self.slot_caches, targets))
        plan: Dict[int, List] = {}
        for dev, (cache, tgt) in enumerate(zip(self.slot_caches, targets)):
            for key in cache.resident:
                if key not in tgt:
                    cache.evict(key)
            for key in sorted(tgt):
                if key not in cache:
                    plan.setdefault(key[0], []).append((dev, key))
        self._upload_plan = plan
        return self._stage_plan(0)

    def _stage_plan(self, li: int) -> int:
        entries = self._upload_plan.pop(li, None)
        if not entries:
            return 0
        return sum(self.slot_caches[dev].prefetch([key])
                   for dev, key in entries)

    def flush_pending(self) -> None:
        for li in sorted(self._upload_plan):
            for dev, key in self._upload_plan[li]:
                self.slot_caches[dev].prefetch([key])
        self._upload_plan.clear()
        for cache in self.slot_caches:
            cache.commit()

    def _ensure(self, li: int, expert_ids) -> None:
        groups: Dict[int, List] = {}
        for e in expert_ids:
            e = int(e)
            groups.setdefault(self.placement.device_of(li, e),
                              []).append((li, e))
        for dev, keys in groups.items():
            self.slot_caches[dev].ensure(keys, self.victim_fn)

    # -- sharded expert compute ---------------------------------------------
    def _expert_fn(self, li: int):
        """MoE layer ``li``'s ``expert_fn`` over the shards. Commits each
        shard's staged uploads (the point where the unsharded runtime
        commits its one cache) and uploads the layer's host rows."""
        perm = self.placement.perm(li)
        cap = self.placement.cap
        rows = self._perm_rows[li]
        rows[0].copy_(torch.from_numpy(perm))
        rows[1].copy_(torch.from_numpy(self.placement.inv_perm(li)))
        bufs = []
        for dev, cache in enumerate(self.slot_caches):
            homes = perm[dev * cap:(dev + 1) * cap]
            rows[2, dev * cap:(dev + 1) * cap].copy_(
                torch.from_numpy(np.maximum(cache.slot_of[li, homes], 0)))
            bufs.append(cache.commit())
        rows = rows.to(self.device, non_blocking=True)
        shard_rows = [rows[2, i * cap:(i + 1) * cap].to(dev, non_blocking=True)
                      for i, dev in enumerate(self.mesh.devices)]
        mesh, act = self.mesh, self.cfg.act

        def expert_fn(xg, _p):
            yg = moe_ffn_sharded_slots(
                xg.index_select(0, rows[0]), bufs, shard_rows, mesh=mesh,
                act=act, out_dtype=slot_out_dtype(xg.dtype, bufs[0]))
            return yg.index_select(0, rows[1])
        return expert_fn

    def _run_decode_post(self, desc, li, p, x_mid, h2, gates, idx):
        return self.model._decode_block_post(
            p, desc, x_mid, h2, routing=(gates, idx),
            expert_fn=self._expert_fn(li))

    def _run_prefill_post(self, desc, li, p, x_mid, h2, gates, idx,
                          token_mask):
        return self.model._apply_block_post(
            p, desc, x_mid, h2, capacity_factor=2.0, token_mask=token_mask,
            routing=(gates, idx), expert_fn=self._expert_fn(li))
