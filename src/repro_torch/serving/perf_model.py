"""Analytical step-time model for the target device.

The container has no accelerator, so per-layer compute time is derived from
the architecture's FLOP/byte footprint and the HWConfig's peak compute / HBM
bandwidth: ``t = max(flops/peak, bytes/bw)`` (the standard two-term roofline;
the collective term is zero for the single-device serving engine).

Only *relative* latencies matter for reproducing the paper's claims; the
constants are the v5e-flavoured defaults in repro_torch.core.memsim.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.config import ArchConfig
from repro_torch.core.memsim import HWConfig
import repro_torch.config as config_mod


@dataclass(frozen=True)
class LayerCost:
    flops_per_token: float      # excluding experts
    bytes_weights: float        # dense weights touched
    attn_flops_per_token_per_ctx: float  # context-dependent part
    expert_flops_per_token: float        # per activated expert-token
    expert_bytes: float         # weight bytes per activated expert


def layer_cost(cfg: ArchConfig, layer_idx: int, bytes_per_param: int = 2
               ) -> LayerCost:
    d = cfg.d_model
    kind = cfg.block_kind(layer_idx)
    if kind == "attn":
        core = config_mod._attn_params(cfg)
        attn_ctx = 2 * 2 * cfg.n_heads * cfg.head_dim_   # qk^T + att·v
    elif kind == "mamba":
        m = cfg.mamba
        d_in = m.expand * d
        core = 2 * d * d_in + d_in * d + d_in * (2 * m.d_state + 32)
        attn_ctx = 0.0
    else:  # rwkv
        core = 5 * d * d + 2 * d * cfg.d_ff
        attn_ctx = 0.0
    flops = 2 * core
    bytes_w = core * bytes_per_param
    e_flops = 0.0
    e_bytes = 0.0
    if cfg.is_moe_layer(layer_idx):
        m = cfg.moe
        per_expert = config_mod._ffn_params(cfg, m.d_expert)
        e_flops = 2 * per_expert
        e_bytes = per_expert * bytes_per_param
        if m.n_shared_experts:
            sh = m.n_shared_experts * config_mod._ffn_params(
                cfg, m.d_shared or m.d_expert)
            flops += 2 * sh
            bytes_w += sh * bytes_per_param
    elif kind == "attn" or kind == "mamba":
        ffn = config_mod._ffn_params(cfg, cfg.d_ff)
        flops += 2 * ffn
        bytes_w += ffn * bytes_per_param
    return LayerCost(flops, bytes_w, attn_ctx, e_flops, e_bytes)


def expert_bytes(cfg: ArchConfig, bytes_per_param: int = 2) -> int:
    m = cfg.moe
    return int(config_mod._ffn_params(cfg, m.d_expert) * bytes_per_param)


def tier_miss_costs(hw: HWConfig, expert_bytes_: float) -> dict:
    """Seconds one unstaged demand fetch pays per source tier of the
    SSD→DRAM→GPU hierarchy (hops are sequential for a single expert; the
    pipeline only overlaps hops of different experts). The ``ssd/dram``
    ratio is the tier-aware prefetch priority multiplier.

    Analytic mirror of ``MemSim.miss_cost`` for sizing studies without a
    simulator instance; running engines report the simulator's own values
    (which truncate expert bytes) in ``stats()``."""
    dram_hop = expert_bytes_ / (hw.dram_to_dev_gbps * 1e9)
    ssd_hop = expert_bytes_ / (hw.ssd_to_dram_gbps * 1e9) \
        + hw.ssd_op_latency_s
    return {"dram": dram_hop, "ssd": ssd_hop + dram_hop}


def layer_time_mixed(cost: LayerCost, hw: HWConfig,
                     token_ctx: "list[tuple[int, int]]",
                     active_expert_tokens: float = 0.0) -> float:
    """Seconds for one layer over a mixed iteration: ``token_ctx`` is one
    ``(n_tokens, ctx_len)`` pair per live request, so a joining request's
    prefill (many tokens, prompt-length context) and the running requests'
    decode (one token each, their own context) are accounted separately
    instead of lumping the batch under the max context. Weight bytes are
    read once per iteration regardless of batch composition."""
    flops = cost.expert_flops_per_token * active_expert_tokens
    for n_tokens, ctx_len in token_ctx:
        flops += (cost.flops_per_token * n_tokens
                  + cost.attn_flops_per_token_per_ctx * n_tokens * ctx_len)
    byts = cost.bytes_weights + cost.expert_bytes * (
        1.0 if active_expert_tokens else 0.0)
    return max(flops / hw.peak_flops, byts / (hw.hbm_gbps * 1e9))


def layer_time(cost: LayerCost, hw: HWConfig, n_tokens: int, ctx_len: int,
               active_expert_tokens: float = 0.0) -> float:
    """Seconds for one layer over ``n_tokens`` (batch×new-tokens) with
    context ``ctx_len``; ``active_expert_tokens`` = Σ_e tokens routed (only
    experts resident on device — transfer stalls are the simulator's job)."""
    flops = (cost.flops_per_token * n_tokens
             + cost.attn_flops_per_token_per_ctx * n_tokens * ctx_len
             + cost.expert_flops_per_token * active_expert_tokens)
    byts = cost.bytes_weights + cost.expert_bytes * (
        1.0 if active_expert_tokens else 0.0)
    # KV-cache read traffic for decode
    byts += 2 * n_tokens * ctx_len * 0  # folded into activation traffic; small
    return max(flops / hw.peak_flops, byts / (hw.hbm_gbps * 1e9))
