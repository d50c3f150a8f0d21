"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave
(attn at offset 4 of each 8-layer period), MoE 16e top-2 every 2nd layer.
[arXiv:2403.19887; hf]. SSM layers use the Mamba-2/SSD formulation of this
framework (Jamba ships Mamba-1; dims per the assigned table are kept —
deviation noted in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab_size=65536, act="swiglu",
    attn_period=8, attn_offset=4,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576,
                  every_n_layers=2),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
)
