"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 routed experts top-1 + 1 shared expert,
interleaved dense/MoE (every other layer MoE), early-fusion multimodal
backbone (text side here) [hf:meta-llama/Llama-4-*; unverified].
~400B total / ~17B active."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    moe_num_experts=128, moe_top_k=1, moe_every=2, moe_offset=1,
    moe_d_ff=8192, moe_shared_d_ff=8192,
    rope_theta=500_000.0,
)
