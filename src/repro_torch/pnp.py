"""`repro_torch.pnp`: numpy-style namespace over first-class posit arrays.

The counterpart of ``repro/pnp.py``, the first-class API of the paper's
arithmetic:

    import repro_torch.pnp as pnp

    a = pnp.asarray([1.25, -0.375], pnp.P16_2)   # PFCVT: f32 -> posit (cuda)
    b = pnp.ones((2,), pnp.P16_2)
    c = a + b                                    # PADD, format from the array
    d = pnp.fma(a, b, c)                         # PFMADD, one rounding
    m = pnp.matmul(A, B)                         # quire-semantics GEMM
    f = c.to_f32()                               # PFCVT.S back to float

Arrays live on the card unless the caller asks for the CPU
(``device="cpu"``); an array made from a tensor keeps that tensor's
device.  Every function dispatches through `repro_torch.kernels.ops`: CUDA
arrays run the CUDA kernels, CPU arrays their plain versions.  Python
scalars and float arrays mix in as values (correctly rounded into the posit
operand's format); combining two posit formats raises
`PositConfigMismatchError`: cast explicitly with `.astype()`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.array import (PositArray, PositConfigMismatchError,
                                    is_posit, result_cfg)
from repro_torch.core.types import (P8_0, P8_2, P16_1, P16_2, P32_2, STANDARD,
                                    PositConfig)
from repro_torch.device import resolve_device
from repro_torch.quant.policy import posit_cast_ste as ste  # noqa: F401

__all__ = [
    "PositArray", "PositConfig", "PositConfigMismatchError", "is_posit",
    "P8_0", "P8_2", "P16_1", "P16_2", "P32_2", "STANDARD",
    "asarray", "frombits", "zeros", "ones", "full", "zeros_like",
    "ones_like", "full_like", "add", "subtract", "multiply", "divide",
    "fma", "reciprocal", "negative", "absolute", "abs", "sign", "where",
    "matmul", "dot", "equal", "not_equal", "less", "less_equal", "greater",
    "greater_equal", "pack", "unpack", "lanes", "ste",
    "to_float32", "to_bfloat16", "astype",
]


def _storage(cfg: PositConfig) -> torch.dtype:
    return getattr(torch, cfg.storage_dtype_name)


def _tensor(x, device) -> torch.Tensor:
    """A tensor keeps its device unless `device` is given; anything else
    lands on `device`, by default the card."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.as_tensor(np.asarray(x),
                           device=resolve_device(device or "cuda"))


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------
def asarray(x, cfg: PositConfig | None = None, *, device=None) -> PositArray:
    """Values -> PositArray (correctly rounded encode; PFCVT direction).

    A PositArray passes through unchanged (cfg, if given, must match: use
    `.astype()` to convert).  Int arrays are rejected as ambiguous: wrap
    payload bits with `frombits`.  device: where plain values go (default
    "cuda"); a tensor stays where it is unless device is given.
    """
    if isinstance(x, PositArray):
        if cfg is not None and cfg != x.cfg:
            raise PositConfigMismatchError(
                f"asarray cannot silently convert {x.cfg} -> {cfg}; use "
                f".astype()")
        return x
    if cfg is None:
        raise TypeError("asarray needs a cfg when given plain values")
    v = _tensor(x, device)
    if not (v.dtype.is_floating_point or v.dtype == torch.bool) \
            and v.ndim > 0:
        raise TypeError("int arrays are ambiguous (values vs payload bits): "
                        "use pnp.frombits(bits, cfg) for payloads or cast to "
                        "float for values")
    from repro_torch.kernels import ops as kops
    return PositArray(kops.encode(v.to(torch.float32), cfg), cfg)


def frombits(bits, cfg: PositConfig, *, device=None) -> PositArray:
    """Wrap existing posit payload ints (no conversion of the bits)."""
    b = _tensor(bits, device)
    if b.dtype.is_floating_point or b.dtype.is_complex:
        raise TypeError(f"frombits takes payload ints, got {b.dtype}; "
                        f"encode values with pnp.asarray(x, cfg)")
    if b.numel():
        lo, hi = int(b.min()), int(b.max())
        if lo < -cfg.sign_bit or hi > cfg.mask:
            raise ValueError(
                f"payload {lo}..{hi} outside the {cfg.n}-bit pattern range "
                f"[-{cfg.sign_bit}, {cfg.mask}]: narrowing would wrap")
    return PositArray(b.to(_storage(cfg)), cfg)


def zeros(shape, cfg: PositConfig, *, device="cuda") -> PositArray:
    return PositArray(torch.zeros(shape, dtype=_storage(cfg),
                                  device=resolve_device(device)), cfg)


def ones(shape, cfg: PositConfig, *, device="cuda") -> PositArray:
    return PositArray(torch.full(shape, cfg.one_bits, dtype=_storage(cfg),
                                 device=resolve_device(device)), cfg)


def full(shape, value, cfg: PositConfig, *, device="cuda") -> PositArray:
    from repro_torch.kernels import ops as kops
    v = torch.full(shape, float(value), dtype=torch.float32,
                   device=resolve_device(device))
    return PositArray(kops.encode(v, cfg), cfg)


def zeros_like(a: PositArray) -> PositArray:
    return zeros(a.shape, a.cfg, device=a.device)


def ones_like(a: PositArray) -> PositArray:
    return ones(a.shape, a.cfg, device=a.device)


def full_like(a: PositArray, value) -> PositArray:
    return full(a.shape, value, a.cfg, device=a.device)


# --------------------------------------------------------------------------
# conversions (PFCVT both directions + format re-round)
# --------------------------------------------------------------------------
def to_float32(a: PositArray) -> torch.Tensor:
    return a.to_f32()


def to_bfloat16(a: PositArray) -> torch.Tensor:
    return a.to_bf16()


def astype(a: PositArray, cfg: PositConfig) -> PositArray:
    return a.astype(cfg)


# --------------------------------------------------------------------------
# arithmetic (PADD/PSUB/PMUL/PDIV/PFMADD + inversion, §VI)
# --------------------------------------------------------------------------
def _pa(x, cfg: PositConfig, like: PositArray | None = None) -> PositArray:
    """A PositArray, or values encoded on the device of `like`."""
    if isinstance(x, PositArray):
        return x
    device = like.device if like is not None else None
    return asarray(x, cfg, device=device)


def _first(*xs) -> PositArray | None:
    return next((x for x in xs if isinstance(x, PositArray)), None)


def add(a, b, cfg: PositConfig | None = None) -> PositArray:
    cfg = result_cfg(a, b, cfg=cfg)
    like = _first(a, b)
    return _pa(a, cfg, like) + _pa(b, cfg, like)


def subtract(a, b, cfg: PositConfig | None = None) -> PositArray:
    cfg = result_cfg(a, b, cfg=cfg)
    like = _first(a, b)
    return _pa(a, cfg, like) - _pa(b, cfg, like)


def multiply(a, b, cfg: PositConfig | None = None) -> PositArray:
    cfg = result_cfg(a, b, cfg=cfg)
    like = _first(a, b)
    return _pa(a, cfg, like) * _pa(b, cfg, like)


def divide(a, b, cfg: PositConfig | None = None, *,
           mode: str = "poly_corrected", nr_rounds: int = 1) -> PositArray:
    """PDIV; mode in {"exact", "poly", "poly_corrected", "pacogen"}."""
    cfg = result_cfg(a, b, cfg=cfg)
    from repro_torch.kernels import ops as kops
    like = _first(a, b)
    a, b = _pa(a, cfg, like), _pa(b, cfg, like)
    return PositArray(kops.divide(a.bits, b.bits, cfg=cfg, mode=mode,
                                  nr_rounds=nr_rounds), cfg)


def fma(a, b, c, cfg: PositConfig | None = None) -> PositArray:
    """round(a*b + c) with a single rounding (PFMADD)."""
    cfg = result_cfg(a, b, c, cfg=cfg)
    from repro_torch.kernels import ops as kops
    like = _first(a, b, c)
    a, b, c = (_pa(x, cfg, like) for x in (a, b, c))
    return PositArray(kops.elementwise("fma", a.bits, b.bits, c.bits,
                                       cfg=cfg), cfg)


def reciprocal(a: PositArray, *, mode: str = "poly_corrected") -> PositArray:
    """1/a (the FPPU inversion op)."""
    return divide(ones_like(a), a, mode=mode)


def negative(a: PositArray) -> PositArray:
    return -a


def absolute(a: PositArray) -> PositArray:
    return a.__abs__()


abs = absolute  # noqa: A001  (numpy-style name)


def sign(a: PositArray) -> PositArray:
    """-1 / 0 / +1 / NaR, as posits of a's format."""
    from repro_torch.core.encode import to_storage
    cfg = a.cfg
    u = a.bits.to(torch.int32) & cfg.mask
    one = cfg.one_bits
    neg = (u >> (cfg.n - 1)) & 1
    out = torch.where(u == 0, 0, torch.where(neg == 1, (-one) & cfg.mask,
                                             one))
    out = torch.where(u == cfg.nar, cfg.nar, out)
    return PositArray(to_storage(out, cfg), cfg)


def where(mask, a, b, cfg: PositConfig | None = None) -> PositArray:
    """Elementwise select; both branches must share one posit format."""
    cfg = result_cfg(a, b, cfg=cfg)
    like = _first(a, b)
    a, b = _pa(a, cfg, like), _pa(b, cfg, like)
    mask = torch.as_tensor(mask, device=a.device)
    return PositArray(torch.where(mask, a.bits, b.bits), cfg)


# --------------------------------------------------------------------------
# linear algebra (quire semantics: one rounding per reduction)
# --------------------------------------------------------------------------
def matmul(a: PositArray, b: PositArray, *, out_posit: bool = True):
    """[m,k] @ [k,n] with quire (single-rounding) accumulation through the
    posit GEMM kernel.  out_posit=False returns the raw f32 accumulator."""
    cfg = result_cfg(a, b)
    from repro_torch.kernels import ops as kops
    like = _first(a, b)
    out = kops.gemm(_pa(a, cfg, like).bits, _pa(b, cfg, like).bits,
                    cfg_a=cfg, cfg_b=cfg,
                    cfg_out=cfg if out_posit else None, out_posit=out_posit)
    return PositArray(out, cfg) if out_posit else out


def dot(a: PositArray, b: PositArray, *, out_posit: bool = True):
    """Fused dot product over the last axis (quire semantics)."""
    cfg = result_cfg(a, b)
    from repro_torch.core.quire import quire_dot
    like = _first(a, b)
    out = quire_dot(_pa(a, cfg, like).bits, _pa(b, cfg, like).bits, cfg,
                    out_posit=out_posit)
    return PositArray(out, cfg) if out_posit else out


# --------------------------------------------------------------------------
# comparisons (free: patterns compare as 2's-complement ints, §VIII)
# --------------------------------------------------------------------------
def equal(a, b):
    return _cmp(a, b, "__eq__")


def not_equal(a, b):
    return _cmp(a, b, "__ne__")


def less(a, b):
    return _cmp(a, b, "__lt__")


def less_equal(a, b):
    return _cmp(a, b, "__le__")


def greater(a, b):
    return _cmp(a, b, "__gt__")


def greater_equal(a, b):
    return _cmp(a, b, "__ge__")


def _cmp(a, b, dunder):
    cfg = result_cfg(a, b)
    like = _first(a, b)
    return getattr(_pa(a, cfg, like), dunder)(_pa(b, cfg, like))


# --------------------------------------------------------------------------
# SIMD packed-word views (paper §VIII-A, C4)
# --------------------------------------------------------------------------
def lanes(a_or_cfg) -> int:
    """SIMD lanes per 32-bit word: 4 for posit8, 2 for posit16."""
    from repro_torch.core.packing import lanes as _lanes
    cfg = a_or_cfg.cfg if isinstance(a_or_cfg, PositArray) else a_or_cfg
    return _lanes(cfg)


def pack(a: PositArray) -> torch.Tensor:
    """[..., L*k] PositArray -> [..., k] int32 packed words (lane 0 in the
    LSBs, the paper's register convention)."""
    from repro_torch.core.packing import pack_words
    return pack_words(a.bits, a.cfg)


def unpack(words, cfg: PositConfig) -> PositArray:
    """[..., k] int32 packed words -> [..., k*L] PositArray."""
    from repro_torch.core.packing import unpack_words
    return PositArray(unpack_words(torch.as_tensor(words), cfg), cfg)
