"""Model configuration dataclasses (the JAX package's, field for field)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    dense_residual: bool = False       # Arctic: dense FFN in parallel
    d_ff_dense: int = 0                # width of the dense residual branch
    aux_loss_weight: float = 0.01
    every_n_layers: int = 1            # Jamba: MoE every 2nd layer


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense|ssm|moe|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                    # 0 → d_model // n_heads
    rope_theta: float = 1e4
    rope_style: str = "full"           # full | half (chatglm 2d) | none
    norm_eps: float = 1e-5
    act: str = "swiglu"                # swiglu | gelu
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_period: int = 0               # hybrid: 1 attn layer per period
    attn_offset: int = 0               # position of attn layer in period
    encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500                # whisper: encoder positions
    frontend: str = ""                 # "" | audio_stub | vision_stub
    n_prefix_embeds: int = 0           # vlm: patch embeds prepended
    max_seq: int = 32768
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables padded to a multiple of 128 (as the
        JAX package pads them, so carried weights keep their shapes);
        decode_step slices the pad columns off."""
        return -(-self.vocab_size // 128) * 128

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def n_params(self) -> int:
        """Analytical parameter count (embeddings + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        dh, hq, hkv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * dh * (hq + 2 * hkv) + hq * dh * d
        dense_ffn = 3 * d * f if self.act == "swiglu" else 2 * d * f
        per_layer = []
        for i in range(self.n_layers):
            p = 2 * d  # norms
            if self._is_attn_layer(i):
                p += attn
            if self.ssm is not None and not self._is_attn_layer(i):
                p += self._ssm_params()
            if self.moe is not None and (i % self.moe.every_n_layers
                                         == self.moe.every_n_layers - 1):
                e = self.moe
                p += d * e.n_experts + 3 * d * e.d_ff_expert * e.n_experts
                if e.dense_residual:
                    p += 3 * d * (e.d_ff_dense or f)
            elif self.ssm is None or self._is_attn_layer(i):
                if self.family != "ssm":
                    p += dense_ffn
            per_layer.append(p)
        total = sum(per_layer) + v * d + d
        if not self.tie_embeddings:
            total += v * d
        if self.encdec:
            enc_attn = d * dh * (hq + 2 * hkv) + hq * dh * d
            total += self.n_enc_layers * (enc_attn + dense_ffn + 2 * d)
            total += self.n_layers * (attn + d)  # cross attention + norm
        return total

    def _is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_period:
            return i % self.attn_period == self.attn_offset
        return True

    def _ssm_params(self) -> int:
        s = self.ssm
        d = self.d_model
        di = s.d_inner(d)
        nh = s.n_heads(d)
        conv_dim = di + 2 * s.n_groups * s.d_state
        in_proj = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
        return (in_proj + conv_dim * s.d_conv + 3 * nh + di
                + di * d)  # conv, A/D/dt_bias, norm, out_proj
