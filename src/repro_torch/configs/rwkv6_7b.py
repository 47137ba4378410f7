"""RWKV6 (Finch) 7B — attention-free, data-dependent decay, 64h x 64d.

[arXiv:2404.05892] Channel-mix d_ff 14336; decode state is O(1) in sequence
length, so long_500k runs natively (sub-quadratic by construction).
"""
from repro_torch.config import ArchConfig, RWKVConfig, BLOCK_RWKV

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # d_model / head_dim
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65536,
    act="relu2",         # rwkv channel-mix uses squared relu
    block_type=BLOCK_RWKV,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, gate_lora=64),
)
