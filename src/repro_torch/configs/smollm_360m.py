"""smollm-360m [hf:HuggingFaceTB/SmolLM-360M] — llama-arch small dense.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152, SwiGLU, tied
embeddings.  Same widths as ``repro/configs/smollm_360m.py``.
"""
from repro_torch.models.transformer import ModelConfig


def full(**ov) -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", n_layers=32, d_model=960, n_heads=15, n_kv=5,
        d_ff=2560, vocab=49152, act="swiglu", **ov)


def smoke(**ov) -> ModelConfig:
    return ModelConfig(
        name="smollm-360m-smoke", n_layers=4, d_model=120, n_heads=6, n_kv=2,
        d_ff=320, vocab=512, act="swiglu", **ov)
