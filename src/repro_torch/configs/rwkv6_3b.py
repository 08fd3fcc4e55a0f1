"""rwkv6-3b "Finch" [arXiv:2404.05892] — attention-free, with
data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536, 40 heads of 64, tied embeddings.
Same widths as ``repro/configs/rwkv6_3b.py``.
"""
from repro_torch.models.transformer import ModelConfig


def full(**ov) -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", n_layers=32, d_model=2560, n_heads=40, n_kv=40,
        d_ff=8960, vocab=65536, block_pattern=("rwkv6",), rwkv_head_dim=64,
        **ov)


def smoke(**ov) -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
        d_ff=224, vocab=512, block_pattern=("rwkv6",), rwkv_head_dim=16, **ov)
