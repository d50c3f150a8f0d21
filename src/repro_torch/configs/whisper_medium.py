"""whisper-medium [audio] — enc-dec; conv/mel frontend is a STUB
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356;
unverified]. Decoder positions use RoPE for framework uniformity."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=51865, act="gelu", encdec=True, n_enc_layers=24,
    enc_seq=1500, frontend="audio_stub",
)
