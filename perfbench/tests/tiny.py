"""Tiny cells for the CPU tests: the two families at a few dozen widths,
served in float32 (the port's plain path and the reference then differ
by rounding alone), written as files into a benchmark root of their
own."""
from __future__ import annotations

import json
from pathlib import Path

QWEN = {
    "name": "tiny-qwen3", "port_arch": "qwen3-moe-235b-a22b",
    "assumed": {"served_dtype": "float32", "prefill_capacity_factor": 2.0},
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
    "head_dim": 16, "vocab_size": 512, "intermediate_size": 128,
    "moe_intermediate_size": 32, "num_experts": 8, "num_experts_per_tok": 2,
    "num_hidden_layers": 2, "norm_topk_prob": True,
    "model_type": "qwen3_moe", "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-06}

DSV2 = {
    "name": "tiny-dsv2", "port_arch": "deepseek-v2-236b",
    "assumed": {"served_dtype": "float32", "prefill_capacity_factor": 2.0},
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
    "vocab_size": 512, "intermediate_size": 128, "moe_intermediate_size": 32,
    "n_routed_experts": 8, "num_experts_per_tok": 2, "n_shared_experts": 1,
    "first_k_dense_replace": 1, "num_hidden_layers": 3,
    "kv_lora_rank": 16, "q_lora_rank": 32, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "norm_topk_prob": False,
    "n_group": 1, "topk_group": 1, "routed_scaling_factor": 1.0,
    "rope_scaling": None, "model_type": "deepseek_v2",
    "rope_theta": 10000, "rms_norm_eps": 1e-06}

MIX = {"loop": "closed", "clients": 2, "stratum": 4, "n_tasks": 3,
       "zipf_a": 1.3, "task_vocab_frac": 0.35,
       "prompt_len": {"dist": "lognormal", "median": 12, "sigma": 0.5,
                      "min": 8, "max": 24},
       "output_len": {"dist": "lognormal", "median": 6, "sigma": 0.3,
                      "min": 4, "max": 8},
       "eamc_warmup": 3}

# 24 sound seeds of the offload cells read 0.0 on the CPU; the planted
# faults read 0.6-6.2 where they show (half the batch reads 0 on some seeds)
LIMIT = 0.2
# the resident cell compares the mean gap: 0.0 on sound runs, 0.1 and
# more under the planted faults
MEAN_LIMIT = 0.02

CELLS = {
    "tiny.qwen3.offload": ("tiny-qwen3", {"weight_slots": 10,
                                          "transfer_dtype": "fp32"}),
    "tiny.qwen3.resident": ("tiny-qwen3", {}),
    "tiny.dsv2.offload": ("tiny-dsv2", {"weight_slots": 10,
                                        "transfer_dtype": "fp32"}),
}


def write(root: Path) -> Path:
    """The tiny configurations, the mix and the cells under ``root``."""
    for sub in ("cells", "configs", "traffic"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for cfg in (QWEN, DSV2):
        (root / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(cfg))
    (root / "traffic" / "tiny-closed.json").write_text(json.dumps(MIX))
    for name, (cfg, extra) in CELLS.items():
        limits = ({"logit_gap_mean": MEAN_LIMIT} if "resident" in name
                  else {"logit_gap": LIMIT})
        cell = {"config": cfg, "traffic": "tiny-closed", "pool_slots": 2,
                "eamc_capacity": 2, "trace_iters": 3,
                "check": {"requests": 3, "tokens": 12, "limits": limits},
                **extra}
        (root / "cells" / f"{name}.json").write_text(json.dumps(cell))
    return root
