"""DeepSeek-V2 236B — MLA (kv_lora 512), 160 routed experts top-6 + 2 shared.

[arXiv:2405.04434] 60L, d 5120, 128 heads; layer 0 is a dense FFN (12288);
experts d_ff 1536; shared experts 2 x 1536.
"""
from repro_torch.config import ArchConfig, AttnConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,     # MLA: all heads share the latent; kept for bookkeeping
    head_dim=128,
    d_ff=12288,         # dense FFN of the first layer
    vocab=102400,
    act="swiglu",
    attn=AttnConfig(mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                                  v_head_dim=128)),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536,
                  n_shared_experts=2, d_shared=1536,
                  first_dense_layers=1),
)
