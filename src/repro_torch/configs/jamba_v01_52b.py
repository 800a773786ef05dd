"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba:attention 7:1 interleave (1 attn layer per period of 8,
offset 4), MoE 16 experts top-2 every other layer [arXiv:2403.19887; hf].
Jamba-v0.1 uses Mamba-1 internally; we adapt to the SSD (Mamba-2) form —
MXU-friendly — per DESIGN.md hardware-adaptation notes."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    moe_num_experts=16, moe_top_k=2, moe_every=2, moe_offset=1,
    moe_d_ff=14336,
    attn_layer_period=8, attn_layer_offset=4,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
)
