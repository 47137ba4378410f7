"""Device expert slot cache: the real half of the offload stack, in torch.

Port of ``repro.core.slot_cache``. The simulator (``core.memsim``) decides
when expert movement happens and what it costs; this module is where
expert weights actually move. :class:`HostExpertStore` takes every routed
expert's weights off the model (only routers and shared experts stay on
the device) into host tensors, one ``(E, ...)`` tensor per MoE layer and
weight name, page-locked when the model lives on a GPU so that uploads
run asynchronously. :class:`ExpertSlotCache` owns ``n_slots << L*E``
device slot buffers and the ``(L, E) -> slot`` table the model's
slot-indexed dispatch reads (``ops.moe_expert_ffn_slots``).

Wire tiers: the store ships each expert in the configured
``transfer_dtype`` (fp32 = the master dtype, fp16, or int8 with fp32
per-output-channel scales). Narrow images are quantized on first use, in
torch on the CPU, bit-equal to ``core.quant.quantize_expert`` of the fp32
view, and kept as the host tier that re-uploads after an eviction read.
The slot buffers hold the wire dtype; the consuming kernel dequantizes.

Upload discipline: every upload is staged, not applied. ``_stage`` issues
``non_blocking`` host->device copies from page-locked memory into
standalone staging tensors on a dedicated copy stream and records an
event; :meth:`ExpertSlotCache.commit` makes the compute stream wait on
those events and copies the staged rows into the slot buffers on the
compute stream. The reference gets its no-alias guarantee from functional
values; here it comes from stream order: every kernel that read a slot
before ``commit`` was enqueued on the compute stream ahead of the copy
that overwrites the slot. ``fenced=True`` adds a wall-clock wait for the
copy stream on every demand miss (the reference's fenced schedule).
"""
from __future__ import annotations

import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.serving import telemetry

Key = Tuple[int, int]          # (moe_layer_idx, expert_idx)

EXPERT_WEIGHT_NAMES = ("w_gate", "w_up", "w_down")
_WIRE_TORCH = {"fp16": torch.float16, "int8": torch.int8}
# commits timed between two readings of ``ExpertSlotCache.commit_ms`` (a
# step commits once a MoE layer)
TIMED_COMMITS = 256


def quantize_weight(w: torch.Tensor, transfer_dtype: str):
    """torch twin of ``quant.quantize_weight`` for the narrow wires, on a
    CPU tensor whose last axis is the output channel: the same fp32
    divisions, round half to even and clip, so the images are bit-equal to
    the numpy ones. -> (wire tensor, fp32 scales | None)."""
    if transfer_dtype == "fp16":
        return w.to(torch.float16), None
    if transfer_dtype == "int8":
        w32 = w.float()
        maxabs = w32.abs().amax(dim=tuple(range(w32.dim() - 1)))
        scale = maxabs / 127.0
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.round(w32 / safe).clamp_(-127, 127).to(torch.int8)
        return q, safe
    raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")


def _page_lock(t: torch.Tensor, locked: List[torch.Tensor]) -> None:
    """Register CPU tensor ``t`` as page-locked memory (exactly its bytes;
    the caching pinned allocator would round it up to a power of two) and
    add it to ``locked``, the list its owner unregisters when it dies."""
    if t.numel():
        err = torch.cuda.cudart().cudaHostRegister(
            t.data_ptr(), t.numel() * t.element_size(), 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister failed: error {int(err)}")
        locked.append(t)


def _page_unlock(locked: List[torch.Tensor]) -> None:
    rt = torch.cuda.cudart()
    for t in locked:
        rt.cudaHostUnregister(t.data_ptr())


class HostExpertStore:
    """Host copy of every routed expert, keyed ``(moe_layer, expert)``.

    Construction moves the experts out of ``model`` (the device copies are
    freed; routers and shared experts stay), so the device holds no more
    than the slot cache's ``n_slots`` experts. On a GPU model the host
    tensors are page-locked. ``transfer_dtype`` selects the wire tier:
    :meth:`wire_expert` returns the expert's wire image (the narrow leaves
    plus ``<name>_scale`` fp32 rows under int8) and
    :attr:`wire_expert_bytes` its exact byte count, the number every
    upload-accounting path and the simulator share.
    """

    def __init__(self, model, *, transfer_dtype: str = "fp32"):
        if transfer_dtype not in quant.WIRE_DTYPES:
            raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}; "
                             f"expected one of {quant.WIRE_DTYPES}")
        self.transfer_dtype = transfer_dtype
        self.device = model.device
        self.n_moe = len(model.moe_layers)
        self.n_experts = model.cfg.moe.n_experts
        pin = self.device.type == "cuda"
        locked: List[torch.Tensor] = []
        if pin:
            weakref.finalize(self, _page_unlock, locked)
        self._layers: List[Dict[str, torch.Tensor]] = []
        for layer_idx in model.moe_layers:
            moe = model.layers[layer_idx].moe
            pick = {}
            for k in EXPERT_WEIGHT_NAMES:
                if not hasattr(moe, k):
                    continue
                w = getattr(moe, k).detach()
                if pin:
                    host = torch.empty(w.shape, dtype=w.dtype)
                    _page_lock(host, locked)
                    host.copy_(w)
                    w = host
                pick[k] = w                          # each leaf: (E, ...)
                delattr(moe, k)
            self._layers.append(pick)
        if pin:
            torch.cuda.empty_cache()
        self.names = tuple(self._layers[0]) if self._layers else ()
        # dtype/shape of one expert's triple (slot-buffer layout)
        self.slot_shapes = {k: tuple(self._layers[0][k].shape[1:])
                            for k in self.names}
        self.dtypes = {k: self._layers[0][k].dtype for k in self.names}
        self.expert_bytes = int(sum(
            np.prod(self.slot_shapes[k]) * self.dtypes[k].itemsize
            for k in self.names))
        # wire tier: the fixed wire layout + lazily filled per-layer images
        self.wire_dtypes = {
            k: _WIRE_TORCH.get(transfer_dtype, self.dtypes[k])
            for k in self.names}
        self.wire_shapes = dict(self.slot_shapes)
        if transfer_dtype == "int8":
            for k in self.names:
                sk = quant.scale_name(k)
                self.wire_shapes[sk] = (self.slot_shapes[k][-1],)
                self.wire_dtypes[sk] = torch.float32
        self.wire_names = tuple(self.wire_shapes)
        self.wire_expert_bytes = int(sum(
            np.prod(self.wire_shapes[k]) * self.wire_dtypes[k].itemsize
            for k in self.wire_names))
        self._wire: List[Dict[str, torch.Tensor]] = []
        self._have = np.zeros((self.n_moe, self.n_experts), bool)
        if transfer_dtype != "fp32":
            for _ in range(self.n_moe):
                img = {k: torch.empty((self.n_experts,) + self.wire_shapes[k],
                                      dtype=self.wire_dtypes[k])
                       for k in self.wire_names}
                if pin:
                    for t in img.values():
                        _page_lock(t, locked)
                self._wire.append(img)

    def expert(self, li: int, e: int) -> Dict[str, torch.Tensor]:
        """Host views of one expert's master-dtype weight triple."""
        return {k: v[e] for k, v in self._layers[li].items()}

    def wire_expert(self, li: int, e: int) -> Dict[str, torch.Tensor]:
        """The expert's wire image in the configured transfer dtype
        (quantized on first use, then served from the host wire tier)."""
        if self.transfer_dtype == "fp32":
            return self.expert(li, e)
        rows = {k: v[e] for k, v in self._wire[li].items()}
        if not self._have[li, e]:
            for name, w in self.expert(li, e).items():
                q, scale = quantize_weight(w, self.transfer_dtype)
                rows[name].copy_(q)
                if scale is not None:
                    rows[quant.scale_name(name)].copy_(scale)
            self._have[li, e] = True
        return rows

    def layer(self, li: int) -> Dict[str, torch.Tensor]:
        return self._layers[li]


class ExpertSlotCache:
    """Fixed-shape device buffers of ``n_slots`` expert wire images plus
    the ``(L, E) -> slot`` routing table.

    Residency is reconciled with the OffloadEngine's GPU cache in two ways:
    :meth:`sync` (iteration boundary: the engine's admit/evict/prefetch
    verdicts become real async uploads and releases) and :meth:`ensure`
    (use time: a routed expert that is not resident is demand-uploaded,
    timed and counted). Eviction victims for demand uploads come from the
    same cache policy object the simulator uses (Algorithm 2 by default).

    Double buffering: uploads land in :attr:`_staged` (slot -> (staging
    tensors, copy-done event)) and become visible only when :meth:`commit`
    copies them into :attr:`bufs` on the compute stream. Bookkeeping
    (``slot_of``/``key_of``) updates at stage time, so ``ensure``/``sync``
    treat staged experts as resident; the math sees them only once the
    consuming step's ``commit`` runs. On the CPU there is no copy stream:
    staging keeps the host images and ``commit`` copies them.

    Attributes outside :meth:`stats`: ``prefetch_used`` counts the
    prefetch-staged experts a later ``ensure`` routed to,
    ``prefetch_unused_evicted`` those evicted first (prefetch precision);
    :meth:`commit_ms` the compute stream's device time in the commits.
    """

    def __init__(self, store: HostExpertStore, n_slots: int, *,
                 fenced: bool = False, device=None):
        self.store = store
        # expert-parallel serving runs one cache per mesh device: the
        # buffers, the staged uploads and the copy stream live on
        # ``device`` (default the store's), so each shard has its own
        # host->device upload stream
        self.device = (store.device if device is None
                       else torch.device(device))
        self.n_slots = int(n_slots)
        self.fenced = bool(fenced)
        self.bufs = {
            name: torch.zeros((self.n_slots,) + store.wire_shapes[name],
                              dtype=store.wire_dtypes[name],
                              device=self.device)
            for name in store.wire_names}
        self._copy_stream = (torch.cuda.Stream(device=self.device)
                             if self.device.type == "cuda" else None)
        self.slot_of = np.full((store.n_moe, store.n_experts), -1, np.int32)
        self.key_of: List[Optional[Key]] = [None] * self.n_slots
        self._free: List[int] = list(range(self.n_slots))
        # staged-but-uncommitted uploads: slot -> (rows, event). Evicting a
        # staged slot drops its entry, so commit never double-writes.
        self._staged: Dict[int, Tuple[Dict[str, torch.Tensor],
                                      Optional[torch.cuda.Event]]] = {}
        # stats (expert-granularity; the serving engine derives per-token
        # rates from these plus its token counters)
        self.hits = 0
        self.misses = 0
        self.demand_uploads = 0
        self.prefetch_uploads = 0
        self.evictions = 0
        self.upload_bytes = 0
        self.demand_stall_s = 0.0
        # keys staged by ``prefetch`` and not routed to since
        self._prefetched: set = set()
        self.prefetch_used = 0
        self.prefetch_unused_evicted = 0
        # a reused pair of timing events a commit since the last
        # ``commit_ms``, for the first ``TIMED_COMMITS`` (CUDA only)
        self._commit_events: List[Tuple[torch.cuda.Event,
                                        torch.cuda.Event]] = []
        self._n_commits = 0

    # -- residency ----------------------------------------------------------
    def __contains__(self, key: Key) -> bool:
        return self.slot_of[key[0], key[1]] >= 0

    @property
    def resident(self) -> List[Key]:
        return [k for k in self.key_of if k is not None]

    def table_row(self, li: int) -> np.ndarray:
        """(E,) expert->slot ids for one layer, clamped to valid slots.
        Non-resident experts point at slot 0: an expert no real token
        routes to contributes nothing, and ``ensure`` makes exactly the
        routed experts resident before the expert FFN runs."""
        return np.maximum(self.slot_of[li], 0).astype(np.int32)

    # -- movement -----------------------------------------------------------
    def _stage(self, key: Key) -> None:
        """Claim a free slot for ``key`` and start its host->device copies
        into standalone staging tensors on the copy stream (``bufs`` is not
        touched: kernels already enqueued keep the weights they read)."""
        slot = self._free.pop()
        w = self.store.wire_expert(*key)
        if self._copy_stream is None:
            self._staged[slot] = (w, None)
        else:
            with torch.cuda.stream(self._copy_stream):
                rows = {name: arr.to(self.device, non_blocking=True)
                        for name, arr in w.items()}
                done = torch.cuda.Event()
                done.record(self._copy_stream)
            self._staged[slot] = (rows, done)
        self.slot_of[key[0], key[1]] = slot
        self.key_of[slot] = key
        self.upload_bytes += self.store.wire_expert_bytes

    def commit(self):
        """Copy every staged upload into the slot buffers on the compute
        stream (after waiting for its host->device copy) and return
        ``bufs``: what the next consuming kernel must be launched with.
        Kernels enqueued before this call read the previous contents."""
        if self._staged:
            compute = (torch.cuda.current_stream(self.device)
                       if self._copy_stream is not None else None)
            pair = self._commit_pair() if compute is not None else None
            if pair is not None:
                pair[0].record(compute)
            for slot, (rows, done) in self._staged.items():
                if done is not None:
                    compute.wait_event(done)
                for name, arr in rows.items():
                    self.bufs[name][slot].copy_(arr)
                    if done is not None:
                        # the staging memory is read on the compute stream
                        arr.record_stream(compute)
            if pair is not None:
                pair[1].record(compute)
            self._staged.clear()
        return self.bufs

    def _commit_pair(self):
        """This commit's timing events; None past ``TIMED_COMMITS`` commits
        since the last ``commit_ms``."""
        self._n_commits += 1
        if self._n_commits > TIMED_COMMITS:
            return None
        if self._n_commits > len(self._commit_events):
            self._commit_events.append(tuple(
                torch.cuda.Event(enable_timing=True) for _ in range(2)))
        return self._commit_events[self._n_commits - 1]

    def commit_ms(self) -> Optional[float]:
        """Device ms the compute stream spent in the commits since the last
        call, from before its first wait for a staged copy to after its last
        landing copy, each commit's pair of events. Read it once the caller
        has waited for the compute stream (a step's read-back): it waits for
        nothing itself. None on the CPU, past ``TIMED_COMMITS`` commits, or
        while a commit is still on the device."""
        if self._copy_stream is None:
            return None
        n, self._n_commits = self._n_commits, 0
        pairs = self._commit_events[:n]
        if n > TIMED_COMMITS or not all(b.query() for _, b in pairs):
            return None
        return sum(a.elapsed_time(b) for a, b in pairs)

    def evict(self, key: Key) -> None:
        slot = int(self.slot_of[key[0], key[1]])
        if slot < 0:
            return
        self.slot_of[key[0], key[1]] = -1
        self.key_of[slot] = None
        self._free.append(slot)
        self._staged.pop(slot, None)   # staged-then-evicted: drop the copy
        self.evictions += 1
        if key in self._prefetched:
            self._prefetched.discard(key)
            self.prefetch_unused_evicted += 1

    def fence(self) -> None:
        """Commit and block until every in-flight slot upload has landed
        on the device."""
        self.commit()
        if self._copy_stream is not None:
            self._copy_stream.synchronize()

    # -- the two reconciliation paths ---------------------------------------
    def sync(self, target_keys: Iterable[Key]) -> int:
        """Reconcile device residency with the offload engine's GPU-cache
        verdicts (iteration boundary). Async: no fence. Returns the number
        of prefetch-class uploads issued."""
        target = set(target_keys)
        for key in self.resident:
            if key not in target:
                self.evict(key)
        return self.prefetch(sorted(target))

    def prefetch(self, keys: Iterable[Key]) -> int:
        """Stage prefetch-class uploads for every non-resident key that
        still has a free slot (never evicts: prefetches are advisory).
        Returns the number staged."""
        n = 0
        for key in keys:
            if key not in self and self._free:
                self._stage(key)
                self._prefetched.add(key)
                self.prefetch_uploads += 1
                n += 1
        return n

    def ensure(self, keys: Sequence[Key], victim_fn=None) -> int:
        """Make ``keys`` (this layer's routed experts) resident now. Misses
        are demand uploads; victims, when the cache is full, come from
        ``victim_fn(resident, protected)``, the engine's cache-policy
        verdict. Returns the number of misses.

        ``demand_stall_s`` counts the host time of the misses: in the
        default overlap mode the issue cost (a first-use quantization
        included), the transfer itself being waited for on the device by
        the consuming kernel; with ``fenced=True`` the full wall time until
        the copy stream has drained. The same clock reads time the span
        ``slot.ensure``."""
        missing = [k for k in keys if k not in self]
        self.hits += len(keys) - len(missing)
        self.misses += len(missing)
        if self._prefetched:
            used = self._prefetched.intersection(keys)
            self.prefetch_used += len(used)
            self._prefetched -= used
        if not missing:
            return 0
        protected = frozenset(keys)
        with telemetry.Span("slot.ensure") as sp:
            for key in missing:
                if not self._free:
                    victim = victim_fn(self.resident, protected) \
                        if victim_fn else next(
                            k for k in self.key_of if k not in protected)
                    if victim is None or victim in protected:
                        raise RuntimeError(
                            f"expert slot cache too small: {self.n_slots} "
                            f"slots cannot hold one layer's {len(keys)} "
                            "routed experts")
                    self.evict(victim)
                self._stage(key)
                self.demand_uploads += 1
            if self.fenced:
                self.fence()
        self.demand_stall_s += sp.t1 - sp.t0
        return len(missing)

    def stats(self) -> dict:
        return {
            "weight_slots": self.n_slots,
            "slot_hits": self.hits,
            "slot_misses": self.misses,
            "demand_uploads": self.demand_uploads,
            "prefetch_uploads": self.prefetch_uploads,
            "slot_evictions": self.evictions,
            "upload_bytes": self.upload_bytes,
            "demand_stall_s": self.demand_stall_s,
            "transfer_dtype": self.store.transfer_dtype,
            "wire_expert_bytes": self.store.wire_expert_bytes,
        }
