"""Posit decode, FPPU stage (i) (paper §IV): bits -> FIR (s, te, M).

Branch-free int32 torch ops, line for line the arithmetic of
``repro/core/decode.py``.  M is an integer significand with value
M / 2^W in [1, 2), W = n - 3, so every downstream product fits int32.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitutil import bit_length32
from repro_torch.core.types import PositConfig

KLASS_ZERO = 0
KLASS_NAR = 1
KLASS_NORMAL = 2


def work_frac_bits(cfg: PositConfig) -> int:
    return cfg.n - 3


def _check_width(cfg: PositConfig) -> None:
    if cfg.n > 16:
        raise NotImplementedError(f"{cfg}: the port's codec covers n <= 16")


def as_bits32(p: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """Any int tensor -> int32 N-bit patterns (zero-extended)."""
    return p.to(torch.int32) & cfg.mask


def classify(u: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    klass = torch.full_like(u, KLASS_NORMAL)
    klass = torch.where(u == 0, KLASS_ZERO, klass)
    return torch.where(u == cfg.nar, KLASS_NAR, klass)


def decode(p: torch.Tensor, cfg: PositConfig):
    """posit bits -> (klass, sign, te, M) int32 tensors.

    M is don't-care on ZERO/NAR lanes (callers mask via klass).
    """
    _check_width(cfg)
    n, es = cfg.n, cfg.es
    u = as_bits32(p, cfg)
    klass = classify(u, cfg)

    s = (u >> (n - 1)) & 1
    absu = torch.where(s == 1, (-u) & cfg.mask, u)
    absu = torch.where(klass == KLASS_NORMAL, absu, 1)

    x = (absu << 1) & cfg.mask                  # drop sign, regime at MSB
    b = (x >> (n - 1)) & 1
    y = torch.where(b == 1, (~x) & cfg.mask, x)
    run = torch.clamp(n - bit_length32(y), max=n - 1)
    k = torch.where(b == 1, run - 1, -run)

    rem = (x << (run + 1)) & cfg.mask           # exponent+fraction
    if es > 0:
        e = rem >> (n - es)
        frac = (rem << es) & cfg.mask
    else:
        e = torch.zeros_like(rem)
        frac = rem
    te = k * cfg.useed_exp + e

    W = work_frac_bits(cfg)
    M = (1 << W) | (frac >> 3)                  # bottom 3+es bits are 0
    return klass, s, te, M


def decode_to_f32(p: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """Exact posit -> float32 (NaR -> NaN, zero -> +0).

    The f32 is assembled from its bit fields and reinterpreted with
    ``.view(torch.float32)``, as ``repro/core/decode.py:90-91`` does.
    """
    if cfg.te_max > 126:
        raise ValueError(f"{cfg}: te range exceeds f32 normal exponents")
    klass, s, te, M = decode(p, cfg)
    W = work_frac_bits(cfg)
    mant23 = (M - (1 << W)) << (23 - W)
    fbits = (s << 31) | ((te + 127) << 23) | mant23
    v = fbits.view(torch.float32)
    v = torch.where(klass == KLASS_ZERO, 0.0, v)
    return torch.where(klass == KLASS_NAR, float("nan"), v)
