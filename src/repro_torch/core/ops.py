"""Posit arithmetic intrinsics, the paper's ISA extension (§VI), in torch.

The counterpart of ``repro/core/ops.py``: PADD/PSUB/PMUL/PDIV/PFMADD and the
inversion as the three-stage FPPU datapath (§V): decode -> int32
significand arithmetic -> RNE `encode_fir`.  Each op is line for line the
reference's int32 sequence on torch tensors, so it is bit-exact against
``repro.core.ops`` and ``repro.core.golden``; these are the plain versions
of the CUDA kernels in ``csrc/posit_elementwise.cu``, which repeat the same
sequence per lane (``csrc/posit_arith.cuh``).

Where the reference's int32 arithmetic wraps (``q * Mb`` in `pdiv` for
p16, the all-ones mask ``(1 << 31) - 1`` in `pfma`) the port computes in
int64 and wraps explicitly; ``//`` floors, as jnp's does.

Division modes: "exact" (long division), "poly" (Alg. 1 + `nr_rounds`
Newton-Raphson, approximate), "poly_corrected" (poly + an exact remainder
fix-up: correctly rounded) and "pacogen" (the LUT baseline of Table II).
Comparisons need no op: patterns compare as 2's-complement integers.
"""
from __future__ import annotations

import torch

from repro_torch.core import recip as _recip
from repro_torch.core.bitutil import bit_length32
from repro_torch.core.decode import (KLASS_NAR, KLASS_ZERO, as_bits32, decode,
                                     work_frac_bits)
from repro_torch.core.encode import encode_fir, to_storage
from repro_torch.core.types import PositConfig

DIV_MODES = ("exact", "poly", "poly_corrected", "pacogen")


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    return bit_length32(torch.clamp(x, min=1))


def _nar_mask(*klasses):
    m = klasses[0] == KLASS_NAR
    for k in klasses[1:]:
        m = m | (k == KLASS_NAR)
    return m


def _low_bits_set(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(x & ((1 << s) - 1)) != 0 for s in [0, 31], the mask built in int64
    (the reference's int32 mask wraps to INT_MAX at s = 31: same bits)."""
    mask = (torch.ones_like(s, dtype=torch.int64) << s.to(torch.int64)) - 1
    return (x.to(torch.int64) & mask) != 0


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def pneg(a, cfg: PositConfig) -> torch.Tensor:
    u = as_bits32(_as_tensor(a), cfg)
    out = torch.where(u == cfg.nar, cfg.nar, (-u) & cfg.mask)
    return to_storage(out, cfg)


def pabs(a, cfg: PositConfig) -> torch.Tensor:
    u = as_bits32(_as_tensor(a), cfg)
    neg = ((u >> (cfg.n - 1)) & 1) == 1
    out = torch.where(neg & (u != cfg.nar), (-u) & cfg.mask, u)
    return to_storage(out, cfg)


def _align_add(s1, te1, M1, s2, te2, M2, G: int, W: int):
    """Shared add stage of padd/pfma: align M2 to M1 with G guard bits and a
    sticky bit, add or subtract, renormalize to [2^W, 2^(W+1)).  Returns
    (s, te, M, sticky, mag) for encode_fir; mag == 0 is an exact zero."""
    M1w = M1 << G
    M2w = M2 << G
    d = torch.clamp(te1 - te2, 0, W + 2)
    M2s = M2w >> d
    sticky = _low_bits_set(M2w, d).to(torch.int32)

    eff_sub = s1 != s2
    mag = torch.where(eff_sub, M1w - M2s, M1w + M2s)
    mag = torch.where(eff_sub & (sticky == 1), mag - 1, mag)

    shift_left = (W + 1) - _bit_length(mag)
    sl = torch.clamp(shift_left, 0, 31)
    sr = torch.clamp(-shift_left, 0, 31)
    lost = _low_bits_set(mag, sr)
    Mn = torch.where(shift_left >= 0, mag << sl, mag >> sr)
    st = sticky | lost.to(torch.int32)
    ten = te1 - shift_left
    return s1, ten, torch.clamp(Mn, min=1 << W), st, mag


# --------------------------------------------------------------------------
# addition / subtraction (paper §IV-A)
# --------------------------------------------------------------------------
def padd(a, b, cfg: PositConfig) -> torch.Tensor:
    a, b = _as_tensor(a), _as_tensor(b)
    Wd = work_frac_bits(cfg)
    ka, sa, tea, Ma = decode(a, cfg)
    kb, sb, teb, Mb = decode(b, cfg)

    # order |p1| >= |p2|
    swap = (teb > tea) | ((teb == tea) & (Mb > Ma))
    s1 = torch.where(swap, sb, sa)
    s2 = torch.where(swap, sa, sb)
    te1 = torch.where(swap, teb, tea)
    te2 = torch.where(swap, tea, teb)
    M1 = torch.where(swap, Mb, Ma)
    M2 = torch.where(swap, Ma, Mb)

    W = Wd + 3                                    # G = 3 guard bits: W = n
    s, te, M, st, mag = _align_add(s1, te1, M1, s2, te2, M2, 3, W)
    res = encode_fir(s, te, M, W, st, cfg)
    res = torch.where(mag == 0, 0, res)
    res = torch.where(ka == KLASS_ZERO, as_bits32(b, cfg), res)
    res = torch.where(kb == KLASS_ZERO, as_bits32(a, cfg), res)
    res = torch.where((ka == KLASS_ZERO) & (kb == KLASS_ZERO), 0, res)
    res = torch.where(_nar_mask(ka, kb), cfg.nar, res)
    return to_storage(res, cfg)


def psub(a, b, cfg: PositConfig) -> torch.Tensor:
    return padd(a, pneg(b, cfg), cfg)


# --------------------------------------------------------------------------
# multiplication (paper §IV-B)
# --------------------------------------------------------------------------
def pmul(a, b, cfg: PositConfig) -> torch.Tensor:
    a, b = _as_tensor(a), _as_tensor(b)
    Wd = work_frac_bits(cfg)
    ka, sa, tea, Ma = decode(a, cfg)
    kb, sb, teb, Mb = decode(b, cfg)

    s = sa ^ sb
    te = tea + teb
    P = Ma * Mb                                   # <= 2*(n-2) <= 28 bits
    W = 2 * Wd
    top = (P >> (W + 1)) & 1
    te = te + top
    M = torch.where(top == 1, P >> 1, P)
    st = torch.where(top == 1, P & 1, 0)

    res = encode_fir(s, te, M, W, st, cfg)
    res = torch.where((ka == KLASS_ZERO) | (kb == KLASS_ZERO), 0, res)
    res = torch.where(_nar_mask(ka, kb), cfg.nar, res)
    return to_storage(res, cfg)


# --------------------------------------------------------------------------
# division (paper §IV-C, §V-A)
# --------------------------------------------------------------------------
def pdiv(a, b, cfg: PositConfig, mode: str = "poly_corrected",
         nr_rounds: int = 1) -> torch.Tensor:
    """Posit division.  mode in {"exact", "poly", "poly_corrected",
    "pacogen"}; "poly" and "pacogen" are approximate (nonzero wrong-%),
    "exact" and "poly_corrected" correctly rounded."""
    if mode not in DIV_MODES:
        raise ValueError(f"unknown division mode {mode!r}")
    a, b = _as_tensor(a), _as_tensor(b)
    n = cfg.n
    ka, sa, tea, Ma = decode(a, cfg)
    kb, sb, teb, Mb = decode(b, cfg)
    s = sa ^ sb
    te = tea - teb

    Wq = n
    num = Ma << (Wq + 1)                          # <= 2n-1 bits
    if mode == "exact":
        q = num // Mb
        rem = num - q * Mb
    else:
        q = _recip.approx_quotient(Ma, Mb, cfg, mode=mode,
                                   nr_rounds=nr_rounds, wq=Wq)
        if mode == "poly_corrected":
            # q + floor((num - q*Mb) / Mb) == floor(num / Mb) for any q;
            # q*Mb may pass 2^31 for p16 and wraps, as in the reference
            q = _recip.wrap32(q.to(torch.int64)
                              + (_recip.wrap32(num.to(torch.int64)
                                               - _recip.wmul(q, Mb))
                                 // Mb))
            rem = _recip.wrap32(num.to(torch.int64) - _recip.wmul(q, Mb))
        else:
            rem = torch.zeros_like(q)

    te = te - 1
    big = (q >> (Wq + 1)) & 1                     # q in (2^Wq, 2^(Wq+2))
    stq = torch.where(big == 1, q & 1, 0)
    q = torch.where(big == 1, q >> 1, q)
    te = te + big
    if mode in ("exact", "poly_corrected"):
        st = (rem != 0).to(torch.int32) | stq
    else:
        st = torch.ones_like(q) | stq             # residual unknown: inexact

    res = encode_fir(s, te, torch.clamp(q, min=1 << Wq), Wq, st, cfg)
    res = torch.where(ka == KLASS_ZERO, 0, res)
    res = torch.where(kb == KLASS_ZERO, cfg.nar, res)   # x/0 = NaR
    res = torch.where(_nar_mask(ka, kb), cfg.nar, res)
    return to_storage(res, cfg)


def precip(b, cfg: PositConfig, mode: str = "poly_corrected") -> torch.Tensor:
    """Reciprocal (the FPPU inversion op): 1/b."""
    b = _as_tensor(b)
    ones = torch.full(b.shape, cfg.one_bits, dtype=torch.int32,
                      device=b.device)
    return pdiv(ones, b, cfg, mode=mode)


# --------------------------------------------------------------------------
# fused multiply-add (PFMADD): round(a*b + c) with a single rounding
# --------------------------------------------------------------------------
def pfma(a, b, c, cfg: PositConfig) -> torch.Tensor:
    a, b, c = _as_tensor(a), _as_tensor(b), _as_tensor(c)
    Wd = work_frac_bits(cfg)
    ka, sa, tea, Ma = decode(a, cfg)
    kb, sb, teb, Mb = decode(b, cfg)
    kc, sc, tec, Mc = decode(c, cfg)

    sp = sa ^ sb
    tep = tea + teb
    P = Ma * Mb
    top = (P >> (2 * Wd + 1)) & 1
    tep = tep + top
    P = torch.where(top == 1, P, P << 1)          # normalize, keep every bit
    Wp = 2 * Wd + 1                               # P in [2^Wp, 2^(Wp+1))

    Cw = Mc << (Wp - Wd)

    p_big = (tep > tec) | ((tep == tec) & (P >= Cw))
    s1 = torch.where(p_big, sp, sc)
    s2 = torch.where(p_big, sc, sp)
    te1 = torch.where(p_big, tep, tec)
    te2 = torch.where(p_big, tec, tep)
    M1 = torch.where(p_big, P, Cw)
    M2 = torch.where(p_big, Cw, P)

    W = Wp + 2                                    # G = 2: W = 2n-3 <= 29
    s, te, M, st, mag = _align_add(s1, te1, M1, s2, te2, M2, 2, W)
    res = encode_fir(s, te, M, W, st, cfg)
    res = torch.where(mag == 0, 0, res)

    # a*b == 0 -> c; c == 0 -> round(a*b); the decode stub on zero lanes is
    # garbage, so mask explicitly, in the reference's order
    ab_zero = (ka == KLASS_ZERO) | (kb == KLASS_ZERO)
    c_zero = kc == KLASS_ZERO
    mul_bits = as_bits32(pmul(a, b, cfg), cfg)
    res = torch.where(ab_zero, as_bits32(c, cfg), res)
    res = torch.where(c_zero & ~ab_zero, mul_bits, res)
    res = torch.where(ab_zero & c_zero, 0, res)
    res = torch.where(_nar_mask(ka, kb, kc), cfg.nar, res)
    return to_storage(res, cfg)


# --------------------------------------------------------------------------
# comparisons (free: patterns are monotone 2's-complement integers)
# --------------------------------------------------------------------------
def _signed(a, cfg: PositConfig) -> torch.Tensor:
    u = as_bits32(_as_tensor(a), cfg)
    return torch.where(u >= cfg.sign_bit, u - (1 << cfg.n), u)


def plt(a, b, cfg: PositConfig) -> torch.Tensor:
    return _signed(a, cfg) < _signed(b, cfg)


def peq(a, b, cfg: PositConfig) -> torch.Tensor:
    return as_bits32(_as_tensor(a), cfg) == as_bits32(_as_tensor(b), cfg)
