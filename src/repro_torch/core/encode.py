"""Posit encode, FPPU stage (iii) (paper §IV-D): FIR -> RNE posit bits.

Int32 torch ops mirroring ``repro/core/encode.py``: split te into regime and
exponent, assemble the pattern, round to nearest even on the monotone
pattern, and saturate to maxpos/minpos (a nonzero value never rounds to 0
or NaR).  Every shift amount stays in [0, 31].
"""
from __future__ import annotations

import torch

from repro_torch.core.types import PositConfig


def encode_fir(s, te, M, W: int, sticky, cfg: PositConfig) -> torch.Tensor:
    """RNE-encode (-1)^s * 2^te * (M / 2^W) to int32 N-bit posit patterns.

    M must be normalized to [2^W, 2^(W+1)); `sticky` is 0/1 per element.
    Callers handle ZERO/NAR lanes.
    """
    n, es = cfg.n, cfg.es
    s, te, M, sticky = (torch.as_tensor(t).to(torch.int32)
                        for t in (s, te, M, sticky))

    sat_hi = te > cfg.te_max
    sat_lo = te < cfg.te_min
    te = torch.clamp(te, cfg.te_min, cfg.te_max)
    k = te >> es
    e = te - (k << es)

    k_pos = k >= 0
    rlen = torch.where(k_pos, k + 2, 1 - k)
    ones = (torch.ones_like(k) << (torch.clamp(k, 0, n) + 1)) - 1
    regime = torch.where(k_pos, ones << 1, 1)

    frac = M - (1 << W)
    nre = rlen + es
    body_bits = n - 1
    combined_re = (regime << es) | e

    # case A: some fraction bits survive (nre < n-1)
    ffield = torch.clamp(body_bits - nre, min=0)
    shiftA = torch.clamp(W - ffield, 1, 31)
    keptA = frac >> shiftA
    rA = (frac >> (shiftA - 1)) & 1
    low_maskA = (torch.ones_like(shiftA) << (shiftA - 1)) - 1
    sA = ((frac & low_maskA) != 0).to(torch.int32) | sticky
    bodyA = (combined_re << ffield) | keptA

    # case B: regime+exponent fill the body (nre >= n-1)
    shiftB = torch.clamp(nre - body_bits, 0, 31)
    bodyB = combined_re >> shiftB
    shiftB1 = torch.clamp(shiftB - 1, min=0)
    rB = torch.where(shiftB > 0, (combined_re >> shiftB1) & 1,
                     (frac >> (W - 1)) & 1)
    low_re = (combined_re & ((torch.ones_like(shiftB1) << shiftB1) - 1)) != 0
    low_fr_all = frac != 0
    low_fr_tail = (frac & ((1 << (W - 1)) - 1)) != 0
    sB = torch.where(shiftB > 0, low_re | low_fr_all,
                     low_fr_tail).to(torch.int32) | sticky

    caseA = nre < body_bits
    body = torch.where(caseA, bodyA, bodyB)
    r = torch.where(caseA, rA, rB)
    st = torch.where(caseA, sA, sB)

    g = body & 1
    body = body + (r & (st | g))                # RNE on the monotone pattern

    body = torch.clamp(body, cfg.minpos_bits, cfg.maxpos_bits)
    body = torch.where(sat_hi, cfg.maxpos_bits, body)
    body = torch.where(sat_lo, cfg.minpos_bits, body)
    return torch.where(s == 1, (-body) & cfg.mask, body)


def to_storage(p: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """int32 N-bit patterns -> the storage dtype, sign-extended.

    Sign extension subtracts 2^n from patterns with the top bit set, which
    equals repro's shift-left/arithmetic-shift-right without relying on
    signed overflow.
    """
    x = p & cfg.mask
    x = torch.where(x >= cfg.sign_bit, x - (1 << cfg.n), x)
    return x.to(getattr(torch, cfg.storage_dtype_name))
