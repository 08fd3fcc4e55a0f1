"""bit_length of int32 tensors, exact, from the exponent of an f32 cast.

The same trick as ``repro/core/bitutil.py`` (the CUDA kernels use ``__clz``
instead): f32 conversion is exact below 2^24, and the high-bits-first split
keeps it exact for every non-negative int32 below 2^31.
"""
from __future__ import annotations

import torch


def _bl_small(y: torch.Tensor) -> torch.Tensor:
    f = y.to(torch.float32)
    exp = ((f.view(torch.int32) >> 23) & 0xFF) - 127
    return torch.where(y == 0, 0, exp + 1)


def bit_length32(y: torch.Tensor) -> torch.Tensor:
    """bit_length of non-negative int32 values (exact for y < 2^31)."""
    y = y.to(torch.int32)
    hi = y >> 7
    return torch.where(hi != 0, _bl_small(hi) + 7, _bl_small(y))
