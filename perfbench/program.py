"""The system under test: the port's model and server, as the benchmark
drives them.

Every use of the program (``repro_torch``) by the benchmark is in this
file: the configuration it is given, the model whose parameters the
benchmark fills, the EAMC it is warmed with, the server and its request
API (``submit``, ``step``), its counters (``decode_ms``, the slot cache's
``stats()``), and the probes that record what each kernel launch was
given. The probes wrap the program's functions from outside and change
nothing they compute.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Callable, List, Optional

import numpy as np
import torch

from perfbench import weights as W
from perfbench.reference.dims import Dims

from repro_torch.config import MLAConfig
from repro_torch.configs import get_config
from repro_torch.core.tracer import build_eamc
from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.serving.engine import EngineConfig, TorchModelServer
from repro_torch.serving.request import DONE, Request
from repro_torch.serving.scheduler import SchedulerConfig

# the program's kernels, as the device trace names them
B1_KERNELS = ("gemm_act", "scan_rows")
B3_KERNELS = ("flash_decode_kernel", "combine_kernel")


def arch(cfg: dict, D: Dims):
    """The port's ``ArchConfig`` for configuration file ``cfg``: its
    family's registry entry (``cfg["port_arch"]``) at the file's sizes.
    Refuses a file that states what the port does not compute."""
    if D.routed_scale != 1.0 or cfg.get("n_group", 1) != 1 \
            or cfg.get("rope_scaling"):
        raise ValueError(
            f"{D.name}: the port routes by a plain top-k of the softmax, "
            "scales no routed output and has no rope scaling")
    base = get_config(cfg["port_arch"])
    moe = dataclasses.replace(
        base.moe, n_experts=D.n_experts, top_k=D.top_k, d_expert=D.d_expert,
        n_shared_experts=D.n_shared,
        d_shared=D.d_expert if D.n_shared else 0,
        first_dense_layers=D.first_dense, router_norm_topk=D.norm_topk)
    mla = None if D.mla is None else MLAConfig(**dataclasses.asdict(D.mla))
    attn = dataclasses.replace(base.attn, rope_theta=D.rope_theta,
                               qk_norm=D.qk_norm, mla=mla)
    return dataclasses.replace(
        base, n_layers=D.n_layers, d_model=D.d_model, n_heads=D.n_heads,
        n_kv_heads=D.n_kv_heads, head_dim=D.head_dim, d_ff=D.d_ff_dense,
        vocab=D.vocab, dtype=D.dtype, moe=moe, attn=attn)


def model(A, D: Dims, seed: int, device):
    """The program's model of ``A`` with the seed's weights, made on the
    device."""
    m = Model(A, device=device)
    W.fill_params(dict(m.named_parameters()), D, seed)
    return m


def eamc(m, prompts: List[np.ndarray], capacity: int):
    """The EAMC built from full forwards of ``prompts`` (the launcher's
    offline construction)."""
    dev = m.device

    @torch.inference_mode()
    def run_fn(seq):
        toks = torch.as_tensor(np.asarray(seq)[None], device=dev,
                               dtype=torch.long)
        return m.forward({"tokens": toks})[1]["counts"][:, 0, :] \
            .cpu().numpy()
    return build_eamc(run_fn, prompts, capacity=capacity)


def server(m, A, cell: dict, brain, cache_len: int, device):
    """The server of cell ``cell``: ``pool_slots`` decode rows; with
    ``weight_slots`` the experts move to the page-locked host store and
    stream through that many device slots over the ``transfer_dtype``
    wire, else every expert stays resident (the fused step)."""
    total = len(m.moe_layers) * A.moe.n_experts
    slots = cell.get("weight_slots")
    ecfg = EngineConfig(
        arch=A, gpu_cache_experts=slots or total,
        dram_cache_experts=total,
        scheduler=SchedulerConfig(max_batch=cell["pool_slots"],
                                  policy="prefill"),
        keep_request_eams=False, n_weight_slots=slots,
        transfer_dtype=cell.get("transfer_dtype", "fp32"))
    return TorchModelServer(ecfg, m, eamc=brain, n_slots=cell["pool_slots"],
                            cache_len=cache_len, device=device)


def request(rid: int, prompt, max_new_tokens: int, task: int, srv):
    """A request that arrives now on the server's own clock."""
    return Request(rid=rid, arrival=float(srv.offload.sim.clock),
                   prompt=np.asarray(prompt, np.int32),
                   max_new_tokens=int(max_new_tokens), task_id=int(task))


def done(r) -> bool:
    return r.state == DONE


def served(srv, rid: int) -> List[int]:
    return [int(t) for t in srv.generated.pop(rid)]


def slot_counts(srv) -> Optional[dict]:
    """The slot cache's hit and miss counters (None when all-resident)."""
    if srv.slot_runtime is None:
        return None
    st = srv.slot_runtime.slot_cache.stats()
    return {"hits": st["slot_hits"], "misses": st["slot_misses"]}


def watch_decode(srv, on_step: Callable) -> None:
    """Call ``on_step(n_active, distinct)`` after every pooled decode
    step, with its active rows and, per MoE layer, how many experts its
    active rows routed to."""
    inner = srv._decode

    def _decode(active):
        tok, counts = inner(active)
        on_step(int(np.asarray(active).sum()),
                (np.asarray(counts).sum(axis=1) > 0).sum(axis=-1))
        return tok, counts
    srv._decode = _decode


@contextmanager
def probe(srv, launches: list, step_of: Callable[[], int]):
    """Record every B1 and B3 launch while the block runs, in order, into
    ``launches``: ("b1", step, E, C, d, f, element size, per-expert routed
    counts of its layer) and ("b3", step, B, H, Hkv, hd, element size);
    ``step_of()`` names the harness's current iteration. B1's counts are
    those its prefill or decode step returned (inactive rows count 0)."""
    pending = []
    inner_ffn, inner_slots = ops.moe_expert_ffn, ops.moe_expert_ffn_slots
    inner_attn = ops.decode_attention
    inner_pre, inner_dec = srv._prefill, srv._decode

    def b1(xg, f, esz):
        E, C, d = xg.shape
        rec = ["b1", step_of(), E, C, d, f, esz, None]
        launches.append(rec)
        pending.append(rec)

    def ffn(xg, w_gate, w_up, w_down, **kw):
        b1(xg, w_up.shape[-1], xg.element_size())
        return inner_ffn(xg, w_gate, w_up, w_down, **kw)

    def ffn_slots(xg, bufs, slot_ids, **kw):
        b1(xg, bufs["w_up"].shape[-1], bufs["w_up"].element_size())
        return inner_slots(xg, bufs, slot_ids, **kw)

    def attn(q, k, v, cache_len, *a, **kw):
        B, H, hd = q.shape
        launches.append(["b3", step_of(), B, H, k.shape[2], hd,
                         k.element_size()])
        return inner_attn(q, k, v, cache_len, *a, **kw)

    def settle(per_layer):
        for rec, cnt in zip(pending, per_layer):
            rec[7] = cnt
        del pending[:]

    def prefill(padded, S, slot):
        tok, counts = inner_pre(padded, S, slot)
        settle(list(np.asarray(counts)))
        return tok, counts

    def decode(active):
        tok, counts = inner_dec(active)
        settle(list(np.asarray(counts).sum(axis=1)))
        return tok, counts

    ops.moe_expert_ffn, ops.moe_expert_ffn_slots = ffn, ffn_slots
    ops.decode_attention = attn
    srv._prefill, srv._decode = prefill, decode
    try:
        yield
    finally:
        ops.moe_expert_ffn, ops.moe_expert_ffn_slots = inner_ffn, inner_slots
        ops.decode_attention = inner_attn
        srv._prefill, srv._decode = inner_pre, inner_dec
