"""whisper-large-v3 [audio] — enc-dec, 32L decoder (+32L encoder)
d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866, GELU FFN, layernorm,
conv audio frontend is a STUB per the assignment (input_specs provides
precomputed frame embeddings [B, 1500, d]) [arXiv:2212.04356; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    act="gelu", qkv_bias=True,
    encoder_layers=32, encoder_seq=1500,
)
