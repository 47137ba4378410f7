"""Long-context decode with an attention-free model (RWKV6): the decode
state is O(1) in context length. Port of ``examples/long_context_rwkv.py``:
the same reduced config, a 64-token prefill, 200 decode steps and the
same two report lines (state size; decode position and time per token).

    PYTHONPATH=src python -m repro_torch.examples.long_context_rwkv [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; on the card every
recurrence step goes through the wkv6 kernel.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config("rwkv6-7b").reduced(n_layers=2, d_model=256)
    model = Model(cfg, device=args.device).init(0)
    dev = model.device
    B = 1

    cache = model.init_cache(B, cache_len=8)  # state-based: length-free
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, 64), generator=gen).to(dev)
    logits, cache, _ = model.prefill({"tokens": toks}, cache)

    state_bytes = cache["pos"].nbytes + sum(
        t.nbytes for layer in cache["layers"] for t in layer.values())
    print(f"decode state: {state_bytes/1e6:.2f} MB, constant in context len")
    tok = logits.argmax(-1)
    _sync(dev)
    t0 = time.time()
    n = 200
    for _ in range(n):
        logits, cache, _ = model.serve_step(cache, tok)
        tok = logits.argmax(-1)
    _sync(dev)
    print(f"decoded {n} tokens at position ~{int(cache['pos'][0])}; "
          f"{(time.time() - t0) / n * 1000:.2f} ms/token on {dev.type.upper()}")


if __name__ == "__main__":
    main()
