"""internvl2-2b [vlm] — InternViT frontend (STUB: precomputed patch
embeddings) + InternLM2 backbone. [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab_size=92553, act="swiglu", frontend="vision_stub",
    n_prefix_embeds=256,
)
