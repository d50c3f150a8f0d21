"""Config registry: the 10 architectures of the JAX package × its 4
input-shape cells."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K,
                                      SHAPES, TRAIN_4K, ModelConfig,
                                      MoEConfig, ShapeConfig, SSMConfig)

_MODULES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "yi-9b": "yi_9b",
    "mistral-large-123b": "mistral_large_123b",
    "chatglm3-6b": "chatglm3_6b",
    "starcoder2-7b": "starcoder2_7b",
    "internvl2-2b": "internvl2_2b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "arctic-480b": "arctic_480b",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "whisper-medium": "whisper_medium",
}

ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(include_skipped: bool = False):
    """All (arch, shape) cells. long_500k only for sub-quadratic archs
    (pure full-attention archs skip it); with ``include_skipped`` every
    pair, as (arch, shape, skipped)."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            skipped = shape.name == "long_500k" and not cfg.sub_quadratic
            if skipped and not include_skipped:
                continue
            out.append((arch, shape.name) if not include_skipped
                       else (arch, shape.name, skipped))
    return out


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test scale: same family/composition, tiny dims."""
    kw = dict(
        n_layers=(cfg.attn_period or 1) * (2 if not cfg.attn_period else 1),
        d_model=64, d_head=16, d_ff=0 if cfg.family == "ssm" else 128,
        vocab_size=512, max_seq=128, n_prefix_embeds=min(
            cfg.n_prefix_embeds, 4),
    )
    if cfg.family == "ssm" or cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                              n_groups=1, chunk=8)
    if cfg.n_heads > 1:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = 2 if cfg.n_kv_heads < cfg.n_heads else 4
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64, d_ff_dense=64 if cfg.moe.dense_residual else 0)
    if cfg.encdec:
        kw["n_enc_layers"] = 2
        kw["enc_seq"] = 16
    return dataclasses.replace(cfg, **kw)
