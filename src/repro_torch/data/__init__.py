"""Token data pipeline (numpy; the same tokens as the JAX package's)."""
from repro_torch.data.pipeline import (DataConfig, MemmapTokens,
                                       SyntheticTokens, make_pipeline)

__all__ = ["DataConfig", "SyntheticTokens", "MemmapTokens", "make_pipeline"]
