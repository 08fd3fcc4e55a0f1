"""recurrentgemma-9b [arXiv:2402.19427] — Griffin hybrid: RG-LRU
recurrent blocks and local sliding-window attention, 2:1.

38L (12 x [rglru, rglru, attn_local] + 2 rglru) d_model=4096, 16 query
heads on 1 kv head (MQA) of 256, GeGLU d_ff=12288, vocab=256000, window
2048, embeddings scaled by sqrt(d_model), tied.  Same widths as
``repro/configs/recurrentgemma_9b.py``.
"""
from repro_torch.models.transformer import ModelConfig


def full(**ov) -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", n_layers=38, d_model=4096, n_heads=16,
        n_kv=1, d_ff=12288, vocab=256000, head_dim=256, act="geglu",
        block_pattern=("rglru", "rglru", "attn_local"), window=2048,
        embed_scale=True, **ov)


def smoke(**ov) -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke", n_layers=5, d_model=64, n_heads=4,
        n_kv=1, d_ff=128, vocab=512, head_dim=16, act="geglu",
        block_pattern=("rglru", "rglru", "attn_local"), window=32,
        embed_scale=True, **ov)
