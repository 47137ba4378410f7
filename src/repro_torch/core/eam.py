"""Expert Activation Matrices (EAM) and their collection (EAMC) — §4.

An EAM for one sequence is an ``L×E`` count matrix: ``M[l][e]`` = number of
tokens routed to expert ``e`` of MoE layer ``l`` during the whole generative
inference of that sequence (prompt + generated tokens). The EAMC is a fixed
capacity set of representative EAMs chosen by k-means under the paper's
Eq. (1) distance; it is the prediction database used online by the
activation-aware prefetcher.

The collection has a full online lifecycle (DESIGN.md §4): it can start
empty and *learn* from completed serving sequences (``online_update``,
capacity-bounded insert-or-merge — no k-means on the hot path), fold
low-quality sequences into a bounded background rebuild on distribution
drift (``record_for_reconstruction``/``reconstruct``), and persist across
restarts (``save``/``load``, ``.npz``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

EAM = np.ndarray  # (L, E) float/int counts


def _row_normalize(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    s = m.sum(axis=1, keepdims=True)
    out = np.divide(m, s, out=np.zeros_like(m), where=s > 0)
    return out


def eam_distance(m1: np.ndarray, m2: np.ndarray) -> float:
    """Paper Eq. (1): 1 − mean_l cos(M1[l]/ΣM1[l], M2[l]/ΣM2[l]).

    Rows with zero tokens contribute cosine 0 (maximal distance term); for a
    partially-filled ``cur_eam`` this is a constant offset over candidates,
    so the argmin over the EAMC is decided by the observed layers only.
    Token-count invariance follows from the row normalization.
    """
    a, b = _row_normalize(m1), _row_normalize(m2)
    num = (a * b).sum(axis=1)
    den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
    cos = np.divide(num, den, out=np.zeros_like(num), where=den > 0)
    return float(1.0 - cos.mean())


def _distance_matrix(eams: Sequence[np.ndarray]) -> np.ndarray:
    """Pairwise Eq.(1) distances, vectorized over the collection."""
    if not len(eams):
        return np.zeros((0, 0))
    X = np.stack([_row_normalize(m) for m in eams])        # (N, L, E)
    norms = np.linalg.norm(X, axis=2)                      # (N, L)
    num = np.einsum("ale,ble->abl", X, X)
    den = norms[:, None, :] * norms[None, :, :]
    cos = np.divide(num, den, out=np.zeros_like(num), where=den > 0)
    return 1.0 - cos.mean(axis=2)


@dataclass
class EAMC:
    """Fixed-capacity Expert Activation Matrix Collection (§4.2).

    ``capacity``: P — number of representative EAMs kept.
    Construction = k-means with Eq.(1) distance; the stored representative of
    each cluster is the *member* EAM closest to the centroid (the paper keeps
    real EAMs, not centroids).
    """

    capacity: int
    entries: List[np.ndarray] = field(default_factory=list)
    # distribution-shift handling (§4.3): low-quality sequences are recorded
    # and folded into the next (re)construction.
    pending: List[np.ndarray] = field(default_factory=list)
    history: List[np.ndarray] = field(default_factory=list)
    seed: int = 0
    # retention bound for ``history``/``pending`` (long replays with online
    # learning or record_drift must not accumulate every (L, E) matrix)
    max_history: int = 512
    # online insert-or-merge: Eq.(1) distance at/below which a completed
    # sequence folds into its nearest entry instead of adding a new one
    merge_threshold: float = 0.3
    # lifecycle telemetry (serve report / StepEngine.stats)
    n_online_inserts: int = 0
    n_online_merges: int = 0
    n_reconstructions: int = 0
    # bumped on every entry mutation; consumers caching derived state
    # (e.g. the stall-admission prior) invalidate on it — entry *count*
    # alone is not enough once online merges rewrite entries in place
    version: int = 0

    # -- construction -------------------------------------------------------
    def construct(self, eams: Sequence[np.ndarray], iters: int = 25) -> None:
        """K-means (spherical, Eq.(1) metric) over ``eams``; keeps ≤P reps."""
        eams = [np.asarray(m, np.float64) for m in eams if np.asarray(m).sum() > 0]
        self.history = list(eams)[-self.max_history:]
        self.version += 1
        if not eams:
            self.entries = []
            return
        if len(eams) <= self.capacity:
            self.entries = list(eams)
            return
        rng = np.random.default_rng(self.seed)
        X = np.stack([_row_normalize(m) for m in eams])     # (N, L, E)
        N = len(eams)
        P = self.capacity
        # k-means++ style init on the Eq.(1) metric
        D = _distance_matrix(eams)
        centers = [int(rng.integers(N))]
        for _ in range(P - 1):
            d = np.clip(D[:, centers].min(axis=1), 0.0, None)
            probs = d / d.sum() if d.sum() > 0 else np.full(N, 1.0 / N)
            centers.append(int(rng.choice(N, p=probs)))
        centroids = X[centers].copy()                       # (P, L, E)
        assign = np.zeros(N, np.int64)
        xn = np.linalg.norm(X, axis=2)                      # (N, L)

        def _dists():
            # distances to centroids under Eq.(1)
            cn = np.linalg.norm(centroids, axis=2)          # (P, L)
            num = np.einsum("nle,ple->npl", X, centroids)
            den = xn[:, None, :] * cn[None, :, :]
            cos = np.divide(num, den, out=np.zeros_like(num), where=den > 0)
            return 1.0 - cos.mean(axis=2)                   # (N, P)

        for _ in range(iters):
            dist = _dists()
            new_assign = dist.argmin(axis=1)
            if np.array_equal(new_assign, assign):
                assign = new_assign
                break
            assign = new_assign
            for p in range(P):
                members = X[assign == p]
                if len(members):
                    centroids[p] = members.mean(axis=0)
        # The loop may exit on the iteration budget right after a centroid
        # update, leaving ``dist``/``assign`` computed against the previous
        # centroids — recompute so the representative choice below sees the
        # final geometry. (On convergence-exit this recomputation is
        # bit-identical: the centroids did not move after the last ``dist``.)
        dist = _dists()
        assign = dist.argmin(axis=1)
        self._last_centroids = centroids      # exposed for tests
        self._last_assign = assign
        # representative = member closest to its centroid
        reps = []
        for p in range(P):
            idx = np.where(assign == p)[0]
            if not len(idx):
                continue
            reps.append(eams[int(idx[dist[idx, p].argmin()])])
        self.entries = reps

    # -- online use -----------------------------------------------------------
    def _lookup_cache(self):
        """Precompute row-normalized entries stacked (P, L, E)."""
        if getattr(self, "_norm_entries", None) is None or \
                len(getattr(self, "_norm_ids", ())) != len(self.entries) or \
                any(a is not b for a, b in zip(self._norm_ids, self.entries)):
            self._norm_entries = np.stack(
                [_row_normalize(m) for m in self.entries]) \
                if self.entries else None
            self._norm_ids = tuple(self.entries)
            if self._norm_entries is not None:
                self._norm_norms = np.linalg.norm(self._norm_entries, axis=2)
        return self._norm_entries

    def lookup(self, cur_eam: np.ndarray) -> tuple[Optional[np.ndarray], float]:
        """Nearest stored EAM to the in-flight ``cur_eam`` (Alg. 1 steps
        16-21). Vectorized over the collection — the paper reports 21 us per
        lookup for 300 entries."""
        X = self._lookup_cache()
        if X is None:
            return None, float("inf")
        q = _row_normalize(np.asarray(cur_eam, np.float64))   # (L, E)
        qn = np.linalg.norm(q, axis=1)                        # (L,)
        num = np.einsum("ple,le->pl", X, q)
        den = self._norm_norms * qn[None, :]
        cos = np.divide(num, den, out=np.zeros_like(num), where=den > 0)
        d = 1.0 - cos.mean(axis=1)                            # (P,)
        i = int(d.argmin())
        return self.entries[i], float(d[i])

    # -- online learning (serving-time lifecycle) ------------------------------
    def online_update(self, eam: np.ndarray, *, nearest=None,
                      dist: Optional[float] = None) -> str:
        """Fold one completed sequence's EAM into the collection without a
        k-means pass: capacity-bounded insert-or-merge against the nearest
        entry under Eq. (1). The caller may pass a precomputed ``lookup``
        result (``nearest``/``dist``) to avoid a second scan.

        Returns what happened: ``"merge"`` (within ``merge_threshold`` of an
        entry — counts are summed, so exact-repeat workloads keep their
        representatives instead of duplicating them), ``"insert"`` (novel
        pattern, room left), ``"defer"`` (novel pattern, collection full —
        recorded for the next drift reconstruction, §4.3), or ``"skip"``
        (empty EAM)."""
        eam = np.asarray(eam, np.float64)
        if eam.sum() <= 0:
            return "skip"
        self.history.append(eam.copy())
        if len(self.history) > self.max_history:
            del self.history[: len(self.history) - self.max_history]
        if dist is None:
            nearest, dist = self.lookup(eam)
        if nearest is not None and dist <= self.merge_threshold:
            i = next(j for j, e in enumerate(self.entries) if e is nearest)
            # replace, never mutate in place: the lookup cache is keyed on
            # entry identity, and Eq.(1) is token-count invariant so the
            # summed counts act as an activation-mass-weighted mean
            self.entries[i] = self.entries[i] + eam
            self.n_online_merges += 1
            self.version += 1
            return "merge"
        if len(self.entries) < self.capacity:
            self.entries.append(eam.copy())
            self.n_online_inserts += 1
            self.version += 1
            return "insert"
        self.record_for_reconstruction(eam)
        return "defer"

    # -- drift handling (§4.3) -------------------------------------------------
    def record_for_reconstruction(self, eam: np.ndarray) -> None:
        self.pending.append(np.asarray(eam, np.float64))
        if len(self.pending) > self.max_history:
            del self.pending[: len(self.pending) - self.max_history]

    def reconstruct(self, max_history: Optional[int] = None) -> None:
        """Fold pending low-performance sequences into a rebuilt collection.
        Bounded work: at most ``max_history`` (default: the collection's
        retention bound) recent sequences are re-clustered."""
        if max_history is None:
            max_history = self.max_history
        data = (self.history + self.pending)[-max_history:]
        self.pending = []
        self.n_reconstructions += 1
        self.construct(data)

    # -- persistence (warm restart from yesterday's traces) --------------------
    @staticmethod
    def _resolve_path(path) -> str:
        path = os.fspath(path)
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path) -> str:
        """Persist the collection (entries + lifecycle counters) as ``.npz``.
        Entries are stored as the exact float64 count matrices, so a
        ``load``ed collection returns bit-identical ``lookup`` results.
        Returns the resolved file path (``.npz`` appended if missing)."""
        path = self._resolve_path(path)
        entries = (np.stack([np.asarray(e, np.float64) for e in self.entries])
                   if self.entries else np.zeros((0, 0, 0), np.float64))
        np.savez_compressed(
            path, entries=entries,
            capacity=np.int64(self.capacity), seed=np.int64(self.seed),
            max_history=np.int64(self.max_history),
            merge_threshold=np.float64(self.merge_threshold),
            n_online_inserts=np.int64(self.n_online_inserts),
            n_online_merges=np.int64(self.n_online_merges),
            n_reconstructions=np.int64(self.n_reconstructions))
        return path

    @classmethod
    def load(cls, path) -> "EAMC":
        """Rebuild a saved collection. ``history``/``pending`` are not
        persisted (they are drift-window state, not the prediction database);
        a warm-restarted engine refills them from its own traffic."""
        path = cls._resolve_path(path)
        with np.load(path) as z:
            c = cls(capacity=int(z["capacity"]), seed=int(z["seed"]),
                    max_history=int(z["max_history"]),
                    merge_threshold=float(z["merge_threshold"]))
            ents = np.asarray(z["entries"], np.float64)
            c.entries = [ents[i].copy() for i in range(ents.shape[0])]
            c.n_online_inserts = int(z["n_online_inserts"])
            c.n_online_merges = int(z["n_online_merges"])
            c.n_reconstructions = int(z["n_reconstructions"])
        c.version += 1
        return c
