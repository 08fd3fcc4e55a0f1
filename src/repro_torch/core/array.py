"""First-class posit arrays: payload bits bound to their format.

The torch counterpart of ``repro/core/array.py``.  `PositArray` binds the
payload bits (an int8/int16 tensor) to their `PositConfig`, so the format
travels with the array instead of being threaded through every call site,
as the FPPU's posit register file makes posits a machine type (§VI).

Rules, as in the reference:
  * operators dispatch through `repro_torch.kernels.ops`, so a CUDA array
    runs the CUDA kernels and a CPU array their plain versions, and results
    are bit-identical to the functional `core.ops` intrinsics;
  * combining two PositArrays of different formats raises
    `PositConfigMismatchError`; int tensors and arrays are never taken as
    payloads implicitly (use `pnp.frombits`); Python scalars and float
    tensors/arrays are *values*, correctly rounded into the array's format
    on the array's device before the op;
  * the bits carry no gradient: training crosses the posit boundary through
    the straight-through cast (`quant.policy.posit_cast_ste`, `pnp.ste`).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.types import PositConfig


class PositConfigMismatchError(ValueError):
    """Two posit operands carry different formats (no silent reinterpreting)."""


def is_int_dtype(dt) -> bool:
    if isinstance(dt, torch.dtype):
        return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)
    return np.issubdtype(dt, np.integer)


def is_float_dtype(dt) -> bool:
    if isinstance(dt, torch.dtype):
        return dt.is_floating_point
    return np.issubdtype(dt, np.floating)


class PositArray:
    """Payload bits (int8/int16 tensor) + their `PositConfig`, behaving like
    an array of posit values.

    Construct with `repro_torch.pnp.asarray` (from float values) or
    `pnp.frombits` (from payload ints); the raw constructor converts
    nothing and only checks that the bits have the format's storage dtype.
    """

    __slots__ = ("bits", "cfg")

    # keep numpy from claiming `np_array <op> posit_array`: defer to the
    # reflected operators instead of ufunc broadcasting over the object
    __array_ufunc__ = None
    __array_priority__ = 100

    def __init__(self, bits: torch.Tensor, cfg: PositConfig):
        if not isinstance(cfg, PositConfig):
            raise TypeError(f"cfg must be a PositConfig, got {type(cfg)!r}")
        if bits.dtype != getattr(torch, cfg.storage_dtype_name):
            raise TypeError(f"{cfg} payload must be {cfg.storage_dtype_name},"
                            f" got {bits.dtype}")
        self.bits = bits
        self.cfg = cfg

    # ---- array metadata passthrough ---------------------------------------
    @property
    def shape(self):
        return self.bits.shape

    @property
    def ndim(self) -> int:
        return self.bits.ndim

    @property
    def size(self) -> int:
        return self.bits.numel()

    @property
    def dtype(self):
        """Storage dtype of the payload (int8/int16)."""
        return self.bits.dtype

    @property
    def device(self):
        return self.bits.device

    @property
    def nbytes(self) -> int:
        return self.bits.numel() * self.bits.element_size()

    def __len__(self):
        return len(self.bits)

    def __getitem__(self, idx):
        return PositArray(self.bits[idx], self.cfg)

    def reshape(self, *shape):
        return PositArray(self.bits.reshape(*shape), self.cfg)

    def transpose(self, *axes):
        """numpy semantics: reverse the axes, or permute them by `axes`."""
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        if not axes:
            axes = tuple(reversed(range(self.bits.ndim)))
        return PositArray(self.bits.permute(*axes), self.cfg)

    @property
    def T(self):
        return self.transpose()

    def ravel(self):
        return PositArray(self.bits.reshape(-1), self.cfg)

    def flatten(self):
        return self.ravel()

    def squeeze(self, axis=None):
        bits = self.bits.squeeze() if axis is None else self.bits.squeeze(axis)
        return PositArray(bits, self.cfg)

    def to(self, device) -> "PositArray":
        return PositArray(self.bits.to(device), self.cfg)

    def __repr__(self):
        return (f"PositArray({self.cfg}, shape={tuple(self.bits.shape)}, "
                f"dtype={self.bits.dtype}, device={self.bits.device})")

    # equality-as-elementwise makes the object unhashable, like numpy arrays
    __hash__ = None  # type: ignore[assignment]

    # ---- conversions -------------------------------------------------------
    def to_f32(self) -> torch.Tensor:
        """Exact decode to float32 (PFCVT.S); NaR -> NaN."""
        from repro_torch.kernels import ops as kops
        return kops.decode(self.bits, self.cfg)

    def to_bf16(self) -> torch.Tensor:
        from repro_torch.core.convert import f32_to_bf16
        return f32_to_bf16(self.to_f32())

    def astype(self, cfg: PositConfig) -> "PositArray":
        """Re-round into another posit format (exact when widening, one
        correctly rounded step when narrowing, for n <= 16)."""
        if not isinstance(cfg, PositConfig):
            raise TypeError("astype takes a PositConfig; use to_f32()/to_bf16()"
                            " for float outputs")
        if cfg == self.cfg:
            return self
        from repro_torch.kernels import ops as kops
        return PositArray(kops.encode(self.to_f32(), cfg), cfg)

    def same_format(self, other: "PositArray") -> "PositArray":
        """Return `other` if it is a PositArray of this format, else raise."""
        if not isinstance(other, PositArray):
            raise TypeError(f"expected a PositArray, got {type(other)!r}")
        if other.cfg != self.cfg:
            raise PositConfigMismatchError(
                f"cannot combine {self.cfg} with {other.cfg}")
        return other

    # ---- operand coercion --------------------------------------------------
    def _coerce(self, other) -> "PositArray":
        """Bring `other` into this array's format, or fail loudly.

        PositArray: formats must match exactly.  Python scalars and float
        tensors/arrays: correctly rounded into self.cfg on self's device.
        Int tensors/arrays are rejected: ambiguous between values and bits.
        """
        if isinstance(other, PositArray):
            if other.cfg != self.cfg:
                raise PositConfigMismatchError(
                    f"cannot combine {self.cfg} with {other.cfg}; cast "
                    f"explicitly with .astype()")
            return other
        from repro_torch.kernels import ops as kops
        if isinstance(other, (bool, int, float)):
            v = torch.full((), float(other), dtype=torch.float32,
                           device=self.device)
            return PositArray(kops.encode(v, self.cfg), self.cfg)
        dt = getattr(other, "dtype", None)
        if dt is not None and is_float_dtype(dt):
            v = torch.as_tensor(other).to(device=self.device,
                                          dtype=torch.float32)
            return PositArray(kops.encode(v, self.cfg), self.cfg)
        raise TypeError(
            f"cannot mix PositArray with {type(other).__name__}: int arrays "
            f"are ambiguous (values vs payload bits); wrap payloads with "
            f"pnp.frombits(x, cfg) or convert values with pnp.asarray")

    def _coerce_or_foreign(self, other):
        """_coerce, but mapping only foreign types (None, str, ...) to None
        so ==/!= can fall back to identity.  Format mismatches and int
        arrays stay loud: a silent False against payload bits is the
        wrong-predicate bug the guards exist to prevent."""
        try:
            return self._coerce(other)
        except PositConfigMismatchError:
            raise
        except TypeError:
            dt = getattr(other, "dtype", None)
            if dt is not None and is_int_dtype(dt):
                raise
            return None

    # ---- arithmetic: dispatches through kernels.ops ------------------------
    def _ew(self, other, op: str, reverse: bool = False) -> "PositArray":
        other = self._coerce(other)
        a, b = (other, self) if reverse else (self, other)
        from repro_torch.kernels import ops as kops
        return PositArray(kops.elementwise(op, a.bits, b.bits, cfg=self.cfg),
                          self.cfg)

    def __add__(self, other):
        return self._ew(other, "add")

    def __radd__(self, other):
        return self._ew(other, "add", reverse=True)

    def __sub__(self, other):
        return self._ew(other, "sub")

    def __rsub__(self, other):
        return self._ew(other, "sub", reverse=True)

    def __mul__(self, other):
        return self._ew(other, "mul")

    def __rmul__(self, other):
        return self._ew(other, "mul", reverse=True)

    def __truediv__(self, other):
        other = self._coerce(other)
        from repro_torch.kernels import ops as kops
        return PositArray(kops.divide(self.bits, other.bits, cfg=self.cfg),
                          self.cfg)

    def __rtruediv__(self, other):
        other = self._coerce(other)
        from repro_torch.kernels import ops as kops
        return PositArray(kops.divide(other.bits, self.bits, cfg=self.cfg),
                          self.cfg)

    def __matmul__(self, other):
        other = self._coerce(other)
        from repro_torch.kernels import ops as kops
        out = kops.gemm(self.bits, other.bits, cfg_a=self.cfg, cfg_b=self.cfg,
                        cfg_out=self.cfg, out_posit=True)
        return PositArray(out, self.cfg)

    def __neg__(self):
        from repro_torch.core.ops import pneg
        return PositArray(pneg(self.bits, self.cfg), self.cfg)

    def __pos__(self):
        return self

    def __abs__(self):
        from repro_torch.core.ops import pabs
        return PositArray(pabs(self.bits, self.cfg), self.cfg)

    # ---- comparisons: free on the bit patterns (paper §VIII) ---------------
    def __lt__(self, other):
        from repro_torch.core.ops import plt
        return plt(self.bits, self._coerce(other).bits, self.cfg)

    def __gt__(self, other):
        from repro_torch.core.ops import plt
        return plt(self._coerce(other).bits, self.bits, self.cfg)

    def __le__(self, other):
        from repro_torch.core.ops import plt
        return ~plt(self._coerce(other).bits, self.bits, self.cfg)

    def __ge__(self, other):
        from repro_torch.core.ops import plt
        return ~plt(self.bits, self._coerce(other).bits, self.cfg)

    def __eq__(self, other):  # type: ignore[override]
        from repro_torch.core.ops import peq
        other = self._coerce_or_foreign(other)
        if other is None:
            return NotImplemented
        return peq(self.bits, other.bits, self.cfg)

    def __ne__(self, other):  # type: ignore[override]
        from repro_torch.core.ops import peq
        other = self._coerce_or_foreign(other)
        if other is None:
            return NotImplemented
        return ~peq(self.bits, other.bits, self.cfg)


def is_posit(x: Any) -> bool:
    return isinstance(x, PositArray)


def result_cfg(*operands, cfg: PositConfig | None = None) -> PositConfig:
    """The common format of a mixed operand list: every PositArray operand
    must agree, and so must an explicit `cfg`; raises if none is known."""
    out = cfg
    for x in operands:
        if isinstance(x, PositArray):
            if out is not None and x.cfg != out:
                raise PositConfigMismatchError(
                    f"operand format {x.cfg} conflicts with {out}")
            out = x.cfg
    if out is None:
        raise TypeError("no PositArray operand and no cfg given: cannot "
                        "infer the posit format")
    return out
