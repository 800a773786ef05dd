"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) head_dim=128
d_ff=14336 vocab=131072 (mistral-nemo text backbone); pixtral-ViT vision
tower is a STUB per the assignment (input_specs provides precomputed patch
embeddings) [hf:mistralai/Pixtral-12B-2409; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=131072,
    rope_theta=1_000_000.0,
    num_patches=256,
)
