"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (MHA kv=16) expert
d_ff=1408, 60 routed experts top-4 + shared expert (4x1408=5632), every
layer MoE [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].  ~14.3B total / ~2.7B active."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    moe_num_experts=60, moe_top_k=4, moe_every=1, moe_offset=0,
    moe_d_ff=1408, moe_shared_d_ff=5632,
    qkv_bias=True,
)
