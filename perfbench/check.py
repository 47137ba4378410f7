"""The check that decides ``correct``: the plain reference over a sample of
what the window served.

Once the window has closed and the program is freed, a sample of the
requests that finished in the window, drawn from the seed with the
longest among them, is run through the float32 reference
(``reference/model.py``) once each, over its prompt and the tokens the
program served, on the seed's weights. At every served token the
reference's best logit at that position lies some gap above the served
token's logit (0 where they agree; greedy decoding serves the program's
argmax). Two numbers summarise the sample: ``logit_gap``, the widest gap,
and ``logit_gap_mean``, the mean gap over every served token. The cell's
``check.limits`` names the numbers it compares, each with its limit: a
run is correct when each is within its limit.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference import model as ref
from perfbench.reference.dims import Dims


def sample(finished: Sequence[Tuple[np.ndarray, List[int]]], seed: int,
           n_requests: int, n_tokens: int) -> List[int]:
    """Indices into ``finished`` ((prompt, served tokens) each): the
    longest request, then others in an order drawn from the seed, until
    ``n_tokens`` served tokens or ``n_requests`` requests."""
    if not finished:
        return []
    size = [len(p) + len(s) for p, s in finished]
    longest = int(np.argmax(size))
    rest = [i for i in np.random.default_rng([int(seed), 4])
            .permutation(len(finished)) if i != longest]
    out, toks = [longest], len(finished[longest][1])
    for i in rest:
        if toks >= n_tokens or len(out) >= n_requests:
            break
        out.append(int(i))
        toks += len(finished[i][1])
    return out


def gaps(D: Dims, seed: int, chosen, device, *, control: bool = False):
    """Per chosen (prompt, served) the reference's gap at each served
    token: (best logit - the served token's logit), float32 reference.
    With ``control``, also the gap of the token that the reference in fp8
    (``reference.model``) puts first at each position. -> (served gaps,
    control gaps or None)."""
    seqs, plens, rows = [], [], []
    for prompt, served in chosen:
        S = len(prompt)
        seqs.append(np.concatenate([np.asarray(prompt, np.int64),
                                    np.asarray(served[:-1], np.int64)]))
        plens.append(S)
        rows.append(S - 1)
    lg = ref.logits(D, seed, seqs, plens, device, rows_from=rows)
    tok = [torch.as_tensor(s, device=device) for _, s in chosen]
    best = [x.max(dim=-1).values for x in lg]
    served = [(b - x.gather(1, t[:, None])[:, 0]).cpu()
              for b, x, t in zip(best, lg, tok)]
    if not control:
        return served, None
    lq = ref.logits(D, seed, seqs, plens, device, rows_from=rows, fp8=True)
    pick = [x.argmax(dim=-1) for x in lq]
    ctrl = [(b - x.gather(1, p[:, None])[:, 0]).cpu()
            for b, x, p in zip(best, lg, pick)]
    return served, ctrl


def judge(D: Dims, seed: int, finished, spec: dict, device, *,
          control: bool = False) -> dict:
    """-> {"correct", "numbers": {name: (value, limit)}, "requests",
    "tokens"} for the window's ``finished`` requests under the cell's
    ``check`` spec ({"requests", "tokens", "limits": {name: limit}});
    with ``control``, also "stats" of the program's and the control's
    gaps (``stats``), which the verdict does not read."""
    idx = sample(finished, seed, int(spec["requests"]), int(spec["tokens"]))
    limits = {k: float(v) for k, v in spec["limits"].items()}
    if not idx:
        return {"correct": False,
                "numbers": {k: (None, lim) for k, lim in limits.items()},
                "requests": 0, "tokens": 0}
    chosen = [finished[i] for i in idx]
    served, ctrl = gaps(D, seed, chosen, device, control=control)
    have = stats(served)
    have = {"logit_gap": have["max"], "logit_gap_mean": have["mean"]}
    numbers = {k: (have[k], lim) for k, lim in limits.items()}
    out = {"correct": all(v <= lim for v, lim in numbers.values()),
           "numbers": numbers, "requests": len(idx),
           "tokens": int(sum(len(s) for _, s in chosen))}
    if ctrl is not None:
        out["stats"] = {"program": stats(served), "control": stats(ctrl)}
    return out


def stats(per_request) -> dict:
    """Summaries of per-token gaps: the share of tokens off the
    reference's best, the mean, the 90th and 99th percentiles and the
    widest."""
    g = torch.cat(per_request).double()
    return {"off": float((g > 0).double().mean()), "mean": float(g.mean()),
            "p90": float(torch.quantile(g, 0.9)),
            "p99": float(torch.quantile(g, 0.99)), "max": float(g.max())}
