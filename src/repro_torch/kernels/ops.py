"""Kernel dispatch for the model and serving code.

The counterpart of ``repro/kernels/ops.py`` for the serving path:
`pw_matmul`, `decode`/`encode`, and the paged attention entry points.
The device of the operands decides: CPU tensors take the plain versions,
CUDA tensors the kernels, with no fallback between them.  `KERNELS` names
every kernel wrapper with its plain version, for the launch counters.
"""
from __future__ import annotations

import torch

from repro_torch.core.array import PositArray
from repro_torch.core.types import PositConfig
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import posit_codec as _codec
from repro_torch.kernels import posit_gemm as _gemm

# name -> (kernel wrapper, plain version); wrappers count `.launches`,
# plain versions `.calls`
KERNELS = {
    "decode_block": (_codec.decode_block, _codec.decode_block_plain),
    "encode_block": (_codec.encode_block, _codec.encode_block_plain),
    "paged_append": (_codec.paged_append, _codec.paged_append_plain),
    "pw_gemm": (_gemm.pw_gemm, _gemm.pw_gemm_plain),
    "paged_flash_decode": (_fa.paged_flash_decode,
                           _fa.paged_flash_decode_plain),
    "paged_flash_prefill": (_fa.paged_flash_prefill,
                            _fa.paged_flash_prefill_plain),
}


def reset_counters() -> None:
    for kernel, plain in KERNELS.values():
        kernel.launches = 0
        plain.calls = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, (k, _) in KERNELS.items()}


def plain_counts() -> dict[str, int]:
    return {name: p.calls for name, (_, p) in KERNELS.items()}


def _split(x, cfg: PositConfig | None):
    if isinstance(x, PositArray):
        if cfg is not None and cfg != x.cfg:
            raise ValueError(f"explicit cfg {cfg} contradicts {x.cfg}")
        return x.bits, x.cfg
    if cfg is None:
        raise TypeError("posit payload needs a PositArray or an explicit cfg")
    return x, cfg


def pw_matmul(x: torch.Tensor, w, cfg: PositConfig | None = None, *,
              transpose_b: bool = False) -> torch.Tensor:
    """[..., k] @ posit weight [k, n] -> f32 [..., n] (the linear layer);
    transpose_b: w stored [n, k] (the tied unembedding table)."""
    bits, cfg = _split(w, cfg)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    out = _gemm.pw_gemm(x2, bits, cfg, transpose_b=transpose_b)
    return out.reshape(*lead, bits.shape[0] if transpose_b else bits.shape[1])


def decode(p, cfg: PositConfig | None = None) -> torch.Tensor:
    """Posit payload -> f32 values."""
    bits, cfg = _split(p, cfg)
    return _codec.decode_block(bits, cfg)


def encode(v: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """f32 values -> posit payload bits (raw)."""
    return _codec.encode_block(v, cfg)


def paged_decode_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                           window=None):
    """q [B, H, D] over (PositArray or float) pages -> [B, H, D]."""
    kb, vb, cfg = _unwrap_pages(k_pages, v_pages)
    return _fa.paged_flash_decode(q, kb, vb, page_table, seq_lens,
                                  cfg_kv=cfg, window=window)


def paged_prefill_attention(q, k_pages, v_pages, page_table, seq_lens,
                            q_offset, *, causal=True, window=None,
                            softcap=None):
    """q [B, H, Sq, D] over (PositArray or float) pages -> [B, H, Sq, D]."""
    kb, vb, cfg = _unwrap_pages(k_pages, v_pages)
    return _fa.paged_flash_prefill(q, kb, vb, page_table, seq_lens, q_offset,
                                   cfg_kv=cfg, causal=causal, window=window,
                                   softcap=softcap)


def paged_append(k, v, k_pages, v_pages, page_table, seq_lens,
                 num_new) -> None:
    """Encode and scatter new K/V tokens into the pools, in place."""
    kb, vb, cfg = _unwrap_pages(k_pages, v_pages)
    _codec.paged_append(k, v, kb, vb, page_table, seq_lens, num_new, cfg)


def _unwrap_pages(k_pages, v_pages):
    """(k, v) pools -> raw buffers + format; both posit or both float."""
    if isinstance(k_pages, PositArray) != isinstance(v_pages, PositArray):
        raise TypeError("k and v pages must both be PositArray or both raw")
    if isinstance(k_pages, PositArray):
        k_pages.same_format(v_pages)
        return k_pages.bits, v_pages.bits, k_pages.cfg
    return k_pages, v_pages, None
