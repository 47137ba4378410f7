"""Quickstart: serve a tiny MoE with activation-aware expert offloading.
Port of ``examples/quickstart.py`` over ``TorchModelServer``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds a reduced Qwen3-MoE, traces a small "validation set" into an EAMC
from ``Model.forward``'s expert counts (Figure 2 step 1), then serves two
batched prompts with the full offload stack (prefetch + cache + multi-tier
memory simulator) and prints the per-sequence Expert Activation Matrices
and offload stats. Runs on ``cuda`` unless ``--device cpu`` is given; the
latency printed is the memory simulator's virtual clock.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.tracer import build_eamc
from repro_torch.models import Model
from repro_torch.serving import EngineConfig
from repro_torch.serving.engine import TorchModelServer
from repro_torch.train.data import DataConfig, TokenStream


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    arch = get_config("qwen3-moe-235b-a22b").reduced()
    print(f"model: {arch.name} — {arch.n_layers}L d{arch.d_model} "
          f"{arch.moe.n_experts}e top-{arch.moe.top_k}")
    model = Model(arch, device=args.device).init(0)

    # 1) offline sequence-level tracing -> EAMC (paper §4)
    data = TokenStream(DataConfig(vocab=arch.vocab, seq_len=12, batch=1))

    @torch.inference_mode()
    def run_fn(seq):
        toks = torch.as_tensor(np.asarray(seq)[None], dtype=torch.long,
                               device=model.device)
        return model.forward({"tokens": toks})[1]["counts"][:, 0, :] \
            .cpu().numpy()

    dataset = [b["tokens"][0] for b in data.batches(10)]
    eamc = build_eamc(run_fn, dataset, capacity=6)
    print(f"EAMC built: {len(eamc.entries)} representative EAMs")

    # 2) online serving with activation-aware offloading (paper §5-6)
    cfg = EngineConfig(arch=arch, gpu_cache_experts=4, dram_cache_experts=8)
    server = TorchModelServer(cfg, model, eamc=eamc, device=args.device)
    prompts = np.stack([np.asarray(d[:8]) for d in dataset[:2]])
    out, stats = server.generate(prompts, max_new_tokens=8)
    print("generated token ids:\n", out)
    print("per-sequence EAMs (rows = MoE layers):")
    for i, eam in enumerate(stats["eams"]):
        print(f"  seq {i}:\n{eam.astype(int)}")
    print(f"gpu cache hit ratio: {stats['gpu_hit_ratio']:.3f}")
    print(f"mean per-token latency (virtual): "
          f"{stats['mean_token_latency'] * 1000:.2f} ms")


if __name__ == "__main__":
    main()
