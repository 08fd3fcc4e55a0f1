"""SIMD lane packing, paper §VIII-A (C4).

The counterpart of ``repro/core/packing.py``: the FPPU packs 4 posit8 (or 2
posit16) operands into one 32-bit register.  These helpers give that
packed-word view of posit storage ints (lane 0 in the least-significant
bits, the paper's register convention).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import PositConfig


def lanes(cfg: PositConfig) -> int:
    """SIMD lanes per 32-bit word: 4 for posit8, 2 for posit16 (paper C4)."""
    return 32 // cfg.storage_bits


def pack_words(p: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """[..., L*k] posit storage ints -> [..., k] int32 packed words."""
    L = lanes(cfg)
    b = cfg.storage_bits
    if p.shape[-1] % L:
        raise ValueError(f"last dim {p.shape[-1]} not divisible by {L} lanes")
    u = p.to(torch.int64) & ((1 << b) - 1)
    u = u.reshape(*p.shape[:-1], p.shape[-1] // L, L)
    shifts = torch.arange(L, dtype=torch.int64, device=p.device) * b
    w = torch.sum(u << shifts, dim=-1)            # < 2^32: the word's bits
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def unpack_words(w: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """[..., k] int32 packed words -> [..., k*L] posit storage ints."""
    L = lanes(cfg)
    b = cfg.storage_bits
    shifts = torch.arange(L, dtype=torch.int32, device=w.device) * b
    u = (w.to(torch.int32)[..., None] >> shifts) & ((1 << cfg.n) - 1)
    u = torch.where(u >= 1 << (cfg.n - 1), u - (1 << cfg.n), u)  # sign-extend
    return u.to(getattr(torch, f"int{b}")).reshape(*w.shape[:-1],
                                                   w.shape[-1] * L)


def packed_map(op, w1: torch.Tensor, w2: torch.Tensor,
               cfg: PositConfig) -> torch.Tensor:
    """Apply a two-operand posit op lane-wise on packed words (same opcode,
    L results per word: the paper's SIMD dispatch)."""
    return pack_words(op(unpack_words(w1, cfg), unpack_words(w2, cfg), cfg),
                      cfg)
