"""Device dispatch: a CPU tensor takes the kernel's plain PyTorch version, a
CUDA tensor launches the hand-written kernel (which raises if it cannot
build or launch; there is no fallback)."""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.moe_ffn import moe_ffn


def moe_expert_ffn(xg, w_gate, w_up, w_down, *, act: str = "swiglu"):
    """Grouped expert FFN (E, C, d) -> (E, C, d)."""
    if xg.device.type == "cpu":
        return ref.moe_ffn_ref(xg, w_gate, w_up, w_down, act=act)
    return moe_ffn(xg, w_gate, w_up, w_down, act=act)


def decode_attention(q, k, v, cache_len):
    """Single-token GQA attention over a per-slot-length KV cache."""
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k, v, cache_len)
    return flash_decode(q, k, v, cache_len)
