"""olmoe-1b-7b [arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924] — MoE, 64
experts top-8.

16L d_model=2048 16H d_ff=1024 (per expert) vocab=50304, SwiGLU experts,
tied embeddings.  Same widths as ``repro/configs/olmoe_1b_7b.py``.
"""
from repro_torch.models.transformer import ModelConfig, MoEConfig


def full(**ov) -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16, n_kv=16,
        d_ff=1024, vocab=50304, act="swiglu", moe=MoEConfig(64, 8), **ov)


def smoke(**ov) -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
        d_ff=96, vocab=512, act="swiglu", moe=MoEConfig(8, 2), **ov)
