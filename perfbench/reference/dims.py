"""The sizes of a benchmark configuration, read from its file.

A configuration file holds the model's published ``config.json`` keys
(DeepSeek-V2's or Qwen3-MoE's names) with the cut listed under
``reduced`` and the sizes the benchmark sets itself under ``assumed``.
``dims`` reads them into one flat record that the weights, the plain
reference and the harness share. Imports nothing but the standard library.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MLADims:
    kv_lora_rank: int
    q_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class Dims:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab: int
    d_ff_dense: int            # the leading dense layers' FFN width
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int              # shared experts, each d_expert wide
    first_dense: int           # leading layers with a dense FFN
    norm_topk: bool            # renormalise the top-k gates
    routed_scale: float        # routed experts' output scale
    qk_norm: bool              # per-head RMSNorm of q and k (Qwen3)
    rope_theta: float
    eps: float
    dtype: str                 # the served weights' type, a torch name
    prefill_capacity_factor: float
    mla: Optional[MLADims]

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_dense

    @property
    def moe_layers(self):
        return [i for i in range(self.n_layers) if self.is_moe(i)]


_DTYPES = {"bfloat16": "bfloat16", "float16": "float16",
           "float32": "float32"}


def dims(cfg: dict) -> Dims:
    """The sizes of configuration file ``cfg`` (its parsed JSON). Refuses a
    configuration that routes by groups or scales RoPE: the reference
    computes neither."""
    if (cfg.get("n_group") or 1) > 1 or cfg.get("rope_scaling"):
        raise ValueError(f"{cfg['name']}: group-limited routing or RoPE "
                         "scaling, which the reference does not compute")
    assumed = cfg.get("assumed", {})
    n_experts = cfg.get("n_routed_experts", cfg.get("num_experts"))
    H = cfg["num_attention_heads"]
    mla = None
    if "kv_lora_rank" in cfg:
        mla = MLADims(cfg["kv_lora_rank"], cfg["q_lora_rank"],
                      cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    head_dim = cfg.get("head_dim") or (mla.qk_nope_head_dim if mla
                                       else cfg["hidden_size"] // H)
    return Dims(
        name=cfg["name"],
        n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"],
        n_heads=H,
        n_kv_heads=cfg["num_key_value_heads"],
        head_dim=head_dim,
        vocab=cfg["vocab_size"],
        d_ff_dense=cfg["intermediate_size"],
        n_experts=n_experts,
        top_k=cfg["num_experts_per_tok"],
        d_expert=cfg["moe_intermediate_size"],
        n_shared=cfg.get("n_shared_experts") or 0,
        first_dense=cfg.get("first_k_dense_replace", 0),
        norm_topk=bool(cfg["norm_topk_prob"]),
        routed_scale=float(cfg.get("routed_scaling_factor", 1.0)),
        qk_norm=cfg.get("model_type") == "qwen3_moe",
        rope_theta=float(cfg["rope_theta"]),
        eps=float(cfg["rms_norm_eps"]),
        dtype=_DTYPES[assumed.get("served_dtype",
                                  cfg.get("torch_dtype", "bfloat16"))],
        prefill_capacity_factor=float(assumed["prefill_capacity_factor"]),
        mla=mla,
    )
