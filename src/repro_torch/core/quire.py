"""Quire-style fused accumulation (paper Table I "Quire/Fused support").

The counterpart of ``repro/core/quire.py``: decode posits to exact f32
(lossless for n <= 16), accumulate the dot products in f32, round to posit
once.  One rounding per reduction, with an f32 accumulator instead of the
standard's exact fixed-point quire.  These are the plain torch versions;
`kernels.posit_gemm.posit_gemm` fuses the decode and the single rounding
into the GEMM kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.convert import f32_to_posit
from repro_torch.core.decode import decode_to_f32
from repro_torch.core.types import PositConfig


def quire_matmul(a_bits: torch.Tensor, b_bits: torch.Tensor, cfg: PositConfig,
                 out_posit: bool = True) -> torch.Tensor:
    """[m,k] x [k,n] posit matmul with single-rounding (quire) semantics."""
    acc = decode_to_f32(a_bits, cfg) @ decode_to_f32(b_bits, cfg)
    return f32_to_posit(acc, cfg) if out_posit else acc


def quire_dot(a_bits: torch.Tensor, b_bits: torch.Tensor, cfg: PositConfig,
              out_posit: bool = True) -> torch.Tensor:
    """Fused dot product over the last axis with quire semantics."""
    a = decode_to_f32(a_bits, cfg)
    b = decode_to_f32(b_bits, cfg)
    acc = torch.sum(a * b, dim=-1, dtype=torch.float32)
    return f32_to_posit(acc, cfg) if out_posit else acc
