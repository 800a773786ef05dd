"""Model configuration shared by all 10 assigned architectures.

One dataclass covers the whole pool: dense GQA transformers, MoE,
hybrid Mamba+attention (jamba), pure SSM (mamba2), encoder-decoder
(whisper), and VLM (pixtral).  Family-specific fields default to "off".

The port's copy of the JAX package's ``models/config.py`` (pure Python,
same fields, defaults and accounting), so the port imports nothing of it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int              # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int                   # dense-FFN hidden (0 if none)
    vocab_size: int

    head_dim: int = 0           # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_fraction: float = 1.0  # stablelm uses partial rotary (0.25)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "swiglu"         # swiglu | gelu (whisper)

    # ---- MoE ----
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1          # layer i is MoE iff (i % moe_every == moe_offset)
    moe_offset: int = 0
    moe_d_ff: int = 0           # routed expert hidden
    moe_shared_d_ff: int = 0    # shared-expert hidden (0 = none)
    moe_capacity_factor: float = 1.25

    # ---- SSM (mamba2 / jamba mamba layers) ----
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1
    attn_layer_period: int = 0  # hybrid: 1 attention layer per period
    attn_layer_offset: int = 0

    # ---- encoder-decoder (whisper) ----
    encoder_layers: int = 0
    encoder_seq: int = 0        # stub frontend output frames

    # ---- VLM (pixtral) ----
    num_patches: int = 0        # stub vision tower output patches

    dtype: str = "bfloat16"

    # ------------------------------------------------------------------ --
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    def layer_kind(self, i: int) -> str:
        """ "attn" | "mamba" for the mixer of layer i."""
        if self.family == "ssm":
            return "mamba"
        if self.attn_layer_period:
            return ("attn" if i % self.attn_layer_period ==
                    self.attn_layer_offset else "mamba")
        return "attn"

    def layer_ffn(self, i: int) -> str:
        """ "dense" | "moe" for the FFN of layer i."""
        if (self.moe_num_experts and
                i % self.moe_every == self.moe_offset):
            return "moe"
        return "dense"

    @property
    def block_size(self) -> int:
        """Smallest repeating layer pattern (scan unit)."""
        b = self.moe_every if self.moe_num_experts else 1
        if self.attn_layer_period:
            b = _lcm(b, self.attn_layer_period)
        return b

    # -------------------------------------------------------- accounting --
    def param_count(self) -> int:
        """Exact parameter count (embeddings included)."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        for i in range(self.num_layers):
            n += self._mixer_params(self.layer_kind(i))
            has_ffn = self.layer_ffn(i) == "moe" or self.d_ff > 0
            if has_ffn:
                n += self._ffn_params(self.layer_ffn(i))
            n += d * (2 if has_ffn else 1)            # norms
        n += d                                        # final norm
        if self.encoder_layers:
            for _ in range(self.encoder_layers):
                n += self._attn_params(cross=False) + self._ffn_params("dense") + 2 * d
            n += d
            # decoder cross-attention blocks
            n += self.num_layers * (self._attn_params(cross=True) + d)
        if self.num_patches:
            n += d * d                                # patch merger stub proj
        return n

    def _attn_params(self, cross: bool = False) -> int:
        d = self.d_model
        hd = self.resolved_head_dim
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        b = (self.num_heads * hd + 2 * self.num_kv_heads * hd) if self.qkv_bias else 0
        return q + kv + o + b

    def _mamba_params(self) -> int:
        d = self.d_model
        di = self.ssm_expand * d
        nh = self.ssm_heads
        ns = self.ssm_state
        g = self.ssm_groups
        in_proj = d * (2 * di + 2 * g * ns + nh)      # z, x, B, C, dt
        conv = self.ssm_conv * (di + 2 * g * ns)
        out = di * d
        extras = nh * 2 + di                           # A_log, D, dt_bias... (norm)
        return in_proj + conv + out + extras

    def _mixer_params(self, kind: str) -> int:
        return self._attn_params() if kind == "attn" else self._mamba_params()

    def _ffn_params(self, kind: str) -> int:
        d = self.d_model
        mult = 3 if self.act == "swiglu" else 2
        if kind == "dense":
            return mult * d * self.d_ff
        n = self.moe_num_experts * mult * d * self.moe_d_ff   # routed
        n += d * self.moe_num_experts                         # router
        if self.moe_shared_d_ff:
            n += mult * d * self.moe_shared_d_ff              # shared expert
        return n

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top-k routed + shared)."""
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        mult = 3 if self.act == "swiglu" else 2
        for i in range(self.num_layers):
            has_ffn = self.layer_ffn(i) == "moe" or self.d_ff > 0
            n += self._mixer_params(self.layer_kind(i)) + d * (2 if has_ffn else 1)
            if self.layer_ffn(i) == "dense":
                n += mult * d * self.d_ff
            else:
                n += self.moe_top_k * mult * d * self.moe_d_ff
                n += d * self.moe_num_experts
                if self.moe_shared_d_ff:
                    n += mult * d * self.moe_shared_d_ff
        n += d
        return n


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    base = dict(
        num_layers=max(2, cfg.block_size),
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(max(cfg.num_kv_heads, 0), 2) if cfg.num_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=257,
        head_dim=16 if cfg.num_heads else 0,
    )
    if cfg.moe_num_experts:
        base.update(moe_num_experts=4, moe_top_k=min(cfg.moe_top_k, 2),
                    moe_d_ff=64,
                    moe_shared_d_ff=64 if cfg.moe_shared_d_ff else 0)
    if cfg.ssm_state:
        base.update(ssm_state=16, ssm_head_dim=16)
    if cfg.encoder_layers:
        base.update(encoder_layers=2, encoder_seq=24)
    if cfg.num_patches:
        base.update(num_patches=8)
    if cfg.attn_layer_period:
        base.update(num_layers=2 * cfg.attn_layer_period)
    base.update(overrides)
    return replace(cfg, name=cfg.name + "-smoke", **base)
