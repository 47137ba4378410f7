"""Architecture / run configuration system.

Every assigned architecture is expressed as an :class:`ArchConfig`. Configs are
plain frozen dataclasses so they can be hashed, diffed and printed; the registry
in :mod:`repro_torch.configs` maps ``--arch`` ids to them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Routed mixture-of-experts FFN."""

    n_experts: int
    top_k: int
    d_expert: int                     # hidden dim of each expert FFN
    n_shared_experts: int = 0         # DeepSeek-style always-on experts
    d_shared: int = 0                 # hidden dim of the shared expert(s)
    capacity_factor: float = 1.25     # train-time capacity bound
    router_norm_topk: bool = False    # renormalize top-k probs (Qwen3/Mixtral style)
    moe_layer_period: int = 1         # MoE every k-th layer (Jamba: 2)
    moe_layer_offset: int = 0         # first MoE layer index within the period
    first_dense_layers: int = 0       # DeepSeek-V2: layer 0 is a dense FFN
    aux_loss_coef: float = 0.01       # load-balance loss (training)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 SSM block (Jamba)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 "Finch" time-mix parameters."""

    head_dim: int = 64
    decay_lora: int = 64      # rank of the data-dependent decay LoRA
    # repro-lint: disable=config-drift -- preset-fidelity field from the RWKV-6 paper config; the reduced block implements static gating, so the LoRA rank is recorded but unused until the full gate lands
    gate_lora: int = 64


@dataclass(frozen=True)
class AttnConfig:
    use_rope: bool = True                 # Whisper uses learned absolute positions
    qkv_bias: bool = False
    qk_norm: bool = False                 # Qwen3-style per-head RMSNorm on q/k
    logit_softcap: float = 0.0            # Gemma-2 attention logit soft-capping
    sliding_window: int = 0               # 0 = full attention
    local_global_period: int = 0          # Gemma-2: alternate local/global every k
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()  # Qwen2-VL M-RoPE (t, h, w) half-dim split
    mla: Optional[MLAConfig] = None


# ---------------------------------------------------------------------------
# Main config
# ---------------------------------------------------------------------------

BLOCK_ATTN = "attn"
BLOCK_MAMBA = "mamba"
BLOCK_RWKV = "rwkv"


@dataclass(frozen=True)
class ArchConfig:
    name: str
    # repro-lint: disable=config-drift -- provenance metadata: documents which model family a preset reproduces; intentionally documentation-only, never branched on
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    # repro-lint: disable=config-drift -- provenance metadata: the citation for the preset's numbers; intentionally documentation-only
    source: str                      # citation for the numbers below
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    act: str = "swiglu"              # swiglu | geglu | gelu | relu2
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    post_block_norm: bool = False    # Gemma-2 extra norms after attn/mlp
    embed_scale: bool = False        # Gemma: scale embeddings by sqrt(d_model)
    final_logit_softcap: float = 0.0
    tie_embeddings: bool = False
    attn: AttnConfig = field(default_factory=AttnConfig)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # Block pattern: "attn" default; hybrid archs use attn_layer_period/offset.
    block_type: str = BLOCK_ATTN     # default block for non-hybrid archs
    attn_layer_period: int = 0       # Jamba: one attn layer per period
    attn_layer_offset: int = 0
    # Encoder-decoder (Whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 0         # stub frontend sequence length
    # Modality frontend stub: none | audio | vision
    frontend: str = "none"
    max_seq_len: int = 1 << 20
    dtype: str = "bfloat16"
    # attention implementation for full-sequence paths:
    #   naive   — materializes (S,T) scores (baseline)
    #   blocked — flash-style online-softmax over KV chunks (§Perf lever)
    attn_impl: str = "naive"
    # MoE dispatch granularity:
    #   global  — one global sort/capacity over all B·S tokens (baseline);
    #             under data parallelism GSPMD replicates the (E, C_global)
    #             expert compute on every data shard (§Perf finding)
    #   grouped — per-sequence-group dispatch (GShard-style groups): the
    #             group dim stays batch-sharded, killing the replication
    moe_dispatch: str = "global"
    # decode-time MoE capacity factor: 0 = dropless (C = batch size, exact
    # but pads every expert to B slots — 16x slot waste at decode_32k);
    # >0 = statistical bound C = B·k/E·f (serving-grade, may drop on skew)
    decode_capacity_factor: float = 0.0
    # activation-checkpoint policy for the scanned layer groups:
    #   full — recompute everything in backward (baseline)
    #   dots — save matmul outputs (jax dots_with_no_batch_dims_saveable):
    #          removes the rematerialized forward at the cost of temp memory
    remat_policy: str = "full"

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def block_kind(self, layer_idx: int) -> str:
        """Which block type lives at ``layer_idx`` (decoder stack)."""
        if self.block_type == BLOCK_RWKV:
            return BLOCK_RWKV
        if self.mamba is not None and self.attn_layer_period:
            if layer_idx % self.attn_layer_period == self.attn_layer_offset:
                return BLOCK_ATTN
            return BLOCK_MAMBA
        return BLOCK_ATTN

    def is_moe_layer(self, layer_idx: int) -> bool:
        m = self.moe
        if m is None:
            return False
        if layer_idx < m.first_dense_layers:
            return False
        return layer_idx % m.moe_layer_period == m.moe_layer_offset

    def is_local_attn_layer(self, layer_idx: int) -> bool:
        """Gemma-2 style alternating local/global; local layers use the window."""
        p = self.attn.local_global_period
        if not p or not self.attn.sliding_window:
            return False
        return layer_idx % p == 0

    # Parameter counting -------------------------------------------------
    def param_count(self) -> int:
        """Total parameters (embedding included once; enc-dec counted fully)."""
        return _count_params(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k + shared)."""
        return _count_params(self, active_only=True)

    def reduced(self, n_layers: int = 2, d_model: int = 256, n_experts: int = 4,
                vocab: int = 512) -> "ArchConfig":
        """A smoke-test variant of the same family (2 layers, tiny dims)."""
        d_model = min(d_model, 512)
        n_heads = max(1, min(self.n_heads, 4))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        head_dim = max(32, d_model // n_heads)
        repl = dict(
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=d_model * 2,
            vocab=min(self.vocab, vocab),
            max_seq_len=4096,
            dtype="float32",
        )
        if self.moe is not None:
            k = min(self.moe.top_k, 2)
            repl["moe"] = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, n_experts),
                top_k=k,
                d_expert=d_model,
                d_shared=d_model if self.moe.n_shared_experts else 0,
                first_dense_layers=min(self.moe.first_dense_layers, 1),
            )
        if self.attn.mla is not None:
            repl["attn"] = dataclasses.replace(
                self.attn,
                mla=MLAConfig(kv_lora_rank=64, q_lora_rank=96,
                              qk_nope_head_dim=head_dim, qk_rope_head_dim=32,
                              v_head_dim=head_dim),
            )
        if self.attn.mrope_sections:
            repl.setdefault("attn", self.attn)
            hw = max(2, head_dim // 8)
            repl["attn"] = dataclasses.replace(
                repl["attn"], mrope_sections=(head_dim // 2 - 2 * hw, hw, hw))
        if self.attn.sliding_window:
            repl.setdefault("attn", repl.get("attn", self.attn))
            repl["attn"] = dataclasses.replace(repl["attn"], sliding_window=128)
        if self.mamba is not None:
            repl["mamba"] = dataclasses.replace(self.mamba, d_state=8)
            repl["attn_layer_period"] = min(self.attn_layer_period, 2)
            repl["attn_layer_offset"] = min(self.attn_layer_offset, 1)
        if self.rwkv is not None:
            repl["rwkv"] = RWKVConfig(head_dim=min(64, d_model // 4),
                                      decay_lora=16, gate_lora=16)
        if self.is_encoder_decoder:
            repl["n_encoder_layers"] = n_layers
            repl["encoder_seq_len"] = 64
        return dataclasses.replace(self, name=self.name + "-smoke", **repl)


def _attn_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    a = cfg.attn
    if a.mla is not None:
        m = a.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        p = d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk      # q down/up
        p += d * (m.kv_lora_rank + m.qk_rope_head_dim)                # kv down + k_rope
        p += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
        p += cfg.n_heads * m.v_head_dim * d                           # o proj
        return p
    hd = cfg.head_dim_
    p = d * cfg.n_heads * hd * 2                                      # q, o
    p += d * cfg.n_kv_heads * hd * 2                                  # k, v
    if a.qkv_bias:
        p += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    return p


def _ffn_params(cfg: ArchConfig, d_ff: int) -> int:
    mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    return mult * cfg.d_model * d_ff


def _count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    total = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    n_dec = cfg.n_layers
    for i in range(n_dec):
        kind = cfg.block_kind(i)
        if kind == BLOCK_ATTN:
            total += _attn_params(cfg)
        elif kind == BLOCK_MAMBA:
            m = cfg.mamba
            d_in = m.expand * d
            dt_rank = m.dt_rank or -(-d // 16)
            total += d * d_in * 2                  # in_proj (x, z)
            total += d_in * m.d_conv               # conv
            total += d_in * (dt_rank + 2 * m.d_state) + dt_rank * d_in
            total += d_in * d                      # out proj
        elif kind == BLOCK_RWKV:
            r = cfg.rwkv
            total += 4 * d * d + d * d             # r,k,v,g(wkv) + out
            total += 2 * d * r.decay_lora          # decay lora
            total += d * cfg.d_ff + cfg.d_ff * d   # channel mix
            continue  # rwkv has its own ffn (channel mix) counted above
        if kind != BLOCK_RWKV:
            if cfg.is_moe_layer(i):
                m = cfg.moe
                e = m.top_k if active_only else m.n_experts
                total += e * _ffn_params(cfg, m.d_expert)
                total += m.n_shared_experts * _ffn_params(cfg, m.d_shared or m.d_expert)
                total += d * m.n_experts           # router
            else:
                total += _ffn_params(cfg, cfg.d_ff)
    if cfg.is_encoder_decoder:
        # encoder self-attn + ffn, decoder cross-attn
        total += cfg.n_encoder_layers * (_attn_params(cfg) + _ffn_params(cfg, cfg.d_ff))
        total += n_dec * _attn_params(cfg)
    return total


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
