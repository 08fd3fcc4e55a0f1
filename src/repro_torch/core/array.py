"""A minimal posit array: payload bits bound to their format.

The torch counterpart of ``repro/core/array.py`` for what the serving path
needs: shape/dtype/indexing pass through to the bits, ``to_f32`` decodes
through the codec kernel, and mixing formats raises
`PositConfigMismatchError`.  Posit arithmetic operators are a later port.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import PositConfig


class PositConfigMismatchError(ValueError):
    """Two posit operands carry different formats."""


class PositArray:
    """Payload bits (int8/int16 tensor) + their `PositConfig`."""

    __slots__ = ("bits", "cfg")

    def __init__(self, bits: torch.Tensor, cfg: PositConfig):
        if not isinstance(cfg, PositConfig):
            raise TypeError(f"cfg must be a PositConfig, got {type(cfg)!r}")
        if bits.dtype != getattr(torch, cfg.storage_dtype_name):
            raise TypeError(f"{cfg} payload must be {cfg.storage_dtype_name},"
                            f" got {bits.dtype}")
        self.bits = bits
        self.cfg = cfg

    @property
    def shape(self):
        return self.bits.shape

    @property
    def dtype(self):
        return self.bits.dtype

    @property
    def device(self):
        return self.bits.device

    @property
    def nbytes(self) -> int:
        return self.bits.numel() * self.bits.element_size()

    def __getitem__(self, idx):
        return PositArray(self.bits[idx], self.cfg)

    def to(self, device) -> "PositArray":
        return PositArray(self.bits.to(device), self.cfg)

    def to_f32(self) -> torch.Tensor:
        """Exact decode to float32; NaR -> NaN."""
        from repro_torch.kernels import ops
        return ops.decode(self)

    def same_format(self, other: "PositArray") -> "PositArray":
        """Return `other` if it shares this array's format, else raise."""
        if not isinstance(other, PositArray):
            raise TypeError(f"expected a PositArray, got {type(other)!r}")
        if other.cfg != self.cfg:
            raise PositConfigMismatchError(
                f"cannot combine {self.cfg} with {other.cfg}")
        return other

    def __repr__(self):
        return (f"PositArray({self.cfg}, shape={tuple(self.bits.shape)}, "
                f"dtype={self.bits.dtype}, device={self.bits.device})")

    __hash__ = None  # type: ignore[assignment]
