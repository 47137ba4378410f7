"""EAMC-guided expert placement across an expert-parallel device mesh.

Which shard *holds* each expert (DESIGN.md §8). Every expert has exactly one
*home* device per layer — the device whose slot cache streams its weights and
whose position in the sharded grouped-GEMM weight array it occupies — plus an
optional set of *replica* devices that also keep a resident copy:

- hot experts (high EAMC-predicted activation ratio) replicate onto extra
  shards, which (a) lets the sim's skew model split their token load across
  devices, cutting the all-to-all straggler term, and (b) makes a later home
  flip free (the bytes are already there — no migration upload);
- cold experts live on exactly one shard;
- placement rebalances at sequence boundaries from the same ``finish_seq``
  stream the EAMC consumes: per-layer greedy LPT over EWMA'd activation
  loads, capped at E/D homes per device, preferring devices that already
  hold a replica so a rebalance moves as few experts as possible.

The home assignment is expressed to the jitted compute as a permutation
(``perm``/``inv_perm``) carried as *traced* arrays, so rebalancing never
recompiles. At D=1 every expert is homed on device 0 and ``max_share`` is
1.0 — all single-device behavior (tests, goldens) is unchanged.
"""
from __future__ import annotations

import numpy as np


class ExpertPlacement:
    """Per-layer expert→device assignment with replication.

    ``home``: (L, E) int32 — the owning device of each expert.
    ``replica_mask``: (L, E) int64 — bitmask of devices holding a copy
    (always includes the home bit).
    ``load``: (L, E) float64 — EWMA of per-sequence activation shares.
    """

    def __init__(self, n_layers: int, n_experts: int, n_devices: int, *,
                 decay: float = 0.8, replicas_per_device: int = 1):
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        if n_experts % n_devices != 0:
            raise ValueError(
                f"n_experts {n_experts} must divide by n_devices {n_devices}")
        self.L = n_layers
        self.E = n_experts
        self.D = n_devices
        self.cap = n_experts // n_devices      # homes per device per layer
        self.decay = decay
        self.replicas_per_device = replicas_per_device
        init = np.repeat(np.arange(n_devices, dtype=np.int32), self.cap)
        self.home = np.tile(init, (n_layers, 1))
        self.replica_mask = (np.int64(1) << self.home.astype(np.int64))
        self.load = np.zeros((n_layers, n_experts), np.float64)
        self.seqs_observed = 0
        self.n_rebalances = 0
        self.n_migrations = 0
        self.n_replicas = 0

    # -- learning ------------------------------------------------------------
    def observe(self, eam) -> None:
        """Fold one finished sequence's EAM (L, E) activation matrix into
        the EWMA load estimate (row-normalized so long sequences don't
        dominate). Standalone/test entry point — the offload engine feeds
        placement via ``set_load`` from the ``ExpertPredictor``'s shared
        heat EWMA instead (DESIGN.md §10), which applies this exact update
        to the same finish_seq stream."""
        m = np.asarray(eam, np.float64)
        if m.shape != self.load.shape:
            return
        s = m.sum(axis=1, keepdims=True)
        m = np.divide(m, np.maximum(s, 1e-12))
        self.load = self.decay * self.load + (1.0 - self.decay) * m
        self.seqs_observed += 1

    def set_load(self, heat) -> None:
        """Adopt the predictor-maintained heat EWMA as this placement's
        load estimate (one finished sequence's worth of learning)."""
        if heat is None:
            return
        m = np.asarray(heat, np.float64)
        if m.shape != self.load.shape:
            return
        self.load = m
        self.seqs_observed += 1

    # -- placement decisions -------------------------------------------------
    def rebalance(self) -> int:
        """Per-layer greedy LPT: experts in descending EWMA load order go to
        the least-loaded device with home capacity left; exact load ties
        prefer a device already holding a replica (the flip is free).
        Returns the number of migrations (home moved to a device without a
        resident copy). Replica masks are then re-derived: old copies stay
        (they are real residency until evicted) and the new home is added."""
        if self.D == 1:
            return 0
        migrations = 0
        for li in range(self.L):
            order = np.argsort(-self.load[li], kind="stable")
            fill = np.zeros(self.D, np.int64)
            dev_load = np.zeros(self.D, np.float64)
            new_home = np.empty(self.E, np.int32)
            for e in order:
                has = (self.replica_mask[li, e] >> np.arange(self.D)) & 1
                best = -1
                best_key = None
                for dev in range(self.D):
                    if fill[dev] >= self.cap:
                        continue
                    key = (dev_load[dev], -int(has[dev]))
                    if best_key is None or key < best_key:
                        best, best_key = dev, key
                new_home[e] = best
                fill[best] += 1
                dev_load[best] += self.load[li, e]
            moved = (new_home != self.home[li]) & (
                ((self.replica_mask[li] >> new_home.astype(np.int64)) & 1)
                == 0)
            migrations += int(moved.sum())
            self.home[li] = new_home
            self.replica_mask[li] |= (
                np.int64(1) << new_home.astype(np.int64))
        self.n_rebalances += 1
        self.n_migrations += migrations
        return migrations

    def replicate(self) -> int:
        """Give the hottest experts extra copies: each device donates up to
        ``replicas_per_device`` spare slots per layer to the globally
        hottest experts it doesn't already hold, least-loaded donors first.
        Returns the number of new replicas created."""
        if self.D == 1 or self.replicas_per_device <= 0:
            return 0
        created = 0
        for li in range(self.L):
            budget = np.full(self.D, self.replicas_per_device, np.int64)
            dev_load = np.zeros(self.D, np.float64)
            np.add.at(dev_load, self.home[li], self.load[li])
            order = np.argsort(-self.load[li], kind="stable")
            order = order[: self.D * self.replicas_per_device]
            for e in order:
                if self.load[li, e] <= 0.0:
                    break
                mask = int(self.replica_mask[li, e])
                cands = [dev for dev in range(self.D)
                         if budget[dev] > 0 and not (mask >> dev) & 1]
                if not cands:
                    continue
                dev = min(cands, key=lambda dv: dev_load[dv])
                self.replica_mask[li, e] |= np.int64(1) << dev
                budget[dev] -= 1
                # the replica will absorb roughly half this expert's tokens
                dev_load[dev] += self.load[li, e] * 0.5
                created += 1
        self.n_replicas += created
        return created

    # -- skew model (sim mode) -----------------------------------------------
    def max_share(self, li: int, token_counts) -> float:
        """Largest per-device share of this layer's expert tokens, with
        replicated experts greedily routed to their lightest replica device
        (modelling the cheap per-iteration flips replication buys). The
        expert-parallel layer's effective compute time is
        ``comp * max_share``: 1.0 at D=1 (unchanged single-device model),
        1/D at perfect balance."""
        if self.D == 1:
            return 1.0
        counts = np.asarray(token_counts, np.float64)
        total = float(counts.sum())
        if total <= 0.0:
            return 1.0 / self.D
        dev_load = np.zeros(self.D, np.float64)
        for e in np.argsort(-counts, kind="stable"):
            c = counts[e]
            if c <= 0.0:
                break
            mask = int(self.replica_mask[li, e])
            devs = [dev for dev in range(self.D) if (mask >> dev) & 1]
            dev = min(devs, key=lambda dv: dev_load[dv]) if len(devs) > 1 \
                else devs[0]
            dev_load[dev] += c
        return float(dev_load.max() / total)

    # -- runtime views -------------------------------------------------------
    def device_of(self, li: int, e: int) -> int:
        return int(self.home[li, e])

    def perm(self, li: int) -> np.ndarray:
        """Expert order for the sharded weight array: device-major (device
        i's homes occupy positions [i*cap, (i+1)*cap)), ascending expert id
        within a device. Position p holds expert ``perm[p]``."""
        return np.argsort(self.home[li], kind="stable").astype(np.int32)

    def inv_perm(self, li: int) -> np.ndarray:
        """Expert e sits at position ``inv_perm[e]`` of the sharded array."""
        p = self.perm(li)
        inv = np.empty_like(p)
        inv[p] = np.arange(self.E, dtype=np.int32)
        return inv

    def homes_of_device(self, li: int, dev: int) -> np.ndarray:
        return self.perm(li)[dev * self.cap:(dev + 1) * self.cap]

    def stats(self) -> dict:
        return {
            "n_devices": self.D,
            "placement_rebalances": self.n_rebalances,
            "placement_migrations": self.n_migrations,
            "placement_replicas": self.n_replicas,
            "placement_seqs_observed": self.seqs_observed,
            "replicated_experts": int(
                ((self.replica_mask & (self.replica_mask - 1)) != 0).sum()),
        }
