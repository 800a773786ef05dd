"""Config registry + input specs for the assigned (arch x shape) grid.

Each ``src/repro_torch/configs/<id>.py`` exports ``CONFIG`` with the exact
assignment numbers (configuration only, no weights).  ``input_specs``
gives ``(shape, torch.dtype)`` stand-ins for every model input of a cell
(no allocation); ``shape_supported`` encodes the assignment's skip rules
(long_500k only for sub-quadratic archs; decode shapes only for archs with
a decoder — all ten have one).
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import LM_SHAPES, ModelConfig

ARCH_IDS = [
    "stablelm_12b",
    "qwen15_4b",
    "yi_9b",
    "qwen2_05b",
    "llama4_maverick",
    "qwen2_moe_a27b",
    "whisper_large_v3",
    "jamba_v01_52b",
    "mamba2_27b",
    "pixtral_12b",
]

# assignment ids (cli) -> module names
ALIASES = {
    "stablelm-12b": "stablelm_12b",
    "qwen1.5-4b": "qwen15_4b",
    "yi-9b": "yi_9b",
    "qwen2-0.5b": "qwen2_05b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "whisper-large-v3": "whisper_large_v3",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "mamba2-2.7b": "mamba2_27b",
    "pixtral-12b": "pixtral_12b",
}


def get_config(arch: str) -> ModelConfig:
    mod = ALIASES.get(arch, arch).replace("-", "_").replace(".", "")
    m = importlib.import_module(f"repro_torch.configs.{mod}")
    return m.CONFIG


def shape_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(supported, reason-if-not)."""
    spec = LM_SHAPES[shape]
    if spec.name == "long_500k":
        subquad = cfg.family in ("ssm", "hybrid")
        if not subquad:
            return False, ("pure full-attention arch: 500k-token KV decode "
                           "needs sub-quadratic attention (assignment skip)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: str,
                per_device_batch: Optional[int] = None) -> Dict:
    """``(shape, dtype)`` stand-ins for every model input of this cell.

    train/prefill: {tokens, labels(train), extra_embeds?}
    decode:        {tokens[B,1]} (+ cache built separately)
    """
    spec = LM_SHAPES[shape]
    B, S = spec.global_batch, spec.seq_len
    out: Dict = {}
    if spec.kind in ("train", "prefill"):
        out["tokens"] = ((B, S), torch.int32)
        if spec.kind == "train":
            out["labels"] = ((B, S), torch.int32)
        if cfg.family == "encdec":
            out["extra_embeds"] = ((B, cfg.encoder_seq, cfg.d_model),
                                   torch.bfloat16)
        elif cfg.family == "vlm":
            out["extra_embeds"] = ((B, cfg.num_patches, cfg.d_model),
                                   torch.bfloat16)
    else:  # decode: one new token against a seq_len-deep cache
        out["tokens"] = ((B, 1), torch.int32)
    return out
