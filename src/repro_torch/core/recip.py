"""Reciprocal approximation, the paper's §V-A contribution, in int32 torch.

The counterpart of ``repro/core/recip.py``:

  * Algorithm 1: y = 4*(k2 - x*(k1-x))*(k1-x) on x in [0.5, 1), with the
    paper's optimized constants K1_OPT/K2_OPT (eq. 13);
  * Newton-Raphson rounds y <- y*(2 - x*y);
  * the PACoGen baseline: a 256-entry LUT (8 fraction bits in, 9 out).

The fixed-point datapath (`recip_poly_fx`, `nr_round_fx`, `approx_quotient`)
is int32 arithmetic with two's-complement wraparound, as jnp's int32 is:
every product that can pass 2^31 goes through `wrap32`, so the estimate is
the reference's bit for bit and the CUDA divide kernel
(``csrc/posit_arith.cuh``) can repeat it with uint32 arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.decode import work_frac_bits
from repro_torch.core.types import PositConfig

# Paper §V-A optimized constants (eq. 13 solution).
K1_OPT = 1.4567844114901045
K2_OPT = 1.0009290026616422

# Constants of the original formulation [19] (for the ablation).
K1_REF19 = 1.466
K2_REF19 = 1.0012

PACOGEN_LUT_IN = 8    # fraction bits indexing the LUT (Table II "IN")
PACOGEN_LUT_OUT = 9   # reciprocal fraction bits produced (Table II "OUT")

_YF = 28          # frac bits of the reciprocal estimate y
_SPLIT = 14       # hi/lo split point of 28f operands in the split multiplies


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (jnp int32 semantics)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def wmul(a, b) -> torch.Tensor:
    """int32 product that wraps like jnp's instead of relying on C++ UB."""
    return wrap32(torch.as_tensor(a).to(torch.int64)
                  * torch.as_tensor(b).to(torch.int64))


def recip_poly_f32(x: torch.Tensor, k1: float = K1_OPT,
                   k2: float = K2_OPT) -> torch.Tensor:
    """Algorithm 1 on x in (0.5, 1]: ~1/x with 2 multiplies + shift."""
    b = k1 - x
    c = x * b
    d = k2 - c
    e = d * b
    return 4.0 * e


def nr_round(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One Newton-Raphson refinement of y ~= 1/x."""
    return y * (2.0 - x * y)


def _pacogen_table() -> np.ndarray:
    """PACoGen-style reciprocal LUT: m = 1 + (idx + 0.5) / 2^IN in [1, 2)
    -> round(2^OUT / m), built in float64 with np.round (half to even)."""
    idx = np.arange(1 << PACOGEN_LUT_IN, dtype=np.float64)
    m = 1.0 + (idx + 0.5) / (1 << PACOGEN_LUT_IN)
    y = 1.0 / m
    return np.round(y * (1 << PACOGEN_LUT_OUT)).astype(np.int32)


_PACOGEN_LUT = _pacogen_table()
_LUT_BY_DEVICE: dict[torch.device, torch.Tensor] = {}


def pacogen_lut(device) -> torch.Tensor:
    """The LUT as an int32 tensor on `device`, made once per device (the
    divide kernel takes it as an input, as the Pallas kernel does)."""
    dev = torch.device(device)
    lut = _LUT_BY_DEVICE.get(dev)
    if lut is None:
        lut = torch.from_numpy(_PACOGEN_LUT).to(dev)
        _LUT_BY_DEVICE[dev] = lut
    return lut


def pacogen_index(mb_frac: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """Divisor fraction bits (hidden bit removed) -> LUT index."""
    Wd = work_frac_bits(cfg)
    if Wd >= PACOGEN_LUT_IN:
        return mb_frac >> (Wd - PACOGEN_LUT_IN)
    return mb_frac << (PACOGEN_LUT_IN - Wd)


def pacogen_lut_i32(mb_frac: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """LUT lookup: 1/m mantissa with PACOGEN_LUT_OUT fraction bits."""
    idx = pacogen_index(mb_frac, cfg)
    lut = pacogen_lut(mb_frac.device)
    return lut[idx.long()].to(torch.int32)


def recip_pacogen_f32(mb_frac: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """f32 view of the LUT reciprocal."""
    return (pacogen_lut_i32(mb_frac, cfg).to(torch.float32)
            * (1.0 / (1 << PACOGEN_LUT_OUT)))


# ---- int32 fixed-point datapath ------------------------------------------
def k_fixed(k1: float = K1_OPT, k2: float = K2_OPT) -> tuple[int, int]:
    """(k1 at 14 frac bits, k2 at 28 frac bits), Python's round()."""
    return round(k1 * (1 << 14)), round(k2 * (1 << _YF))


def _mul_y(A: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """(A * Y) >> 14 with Y split at 14 bits so both partial products fit
    int32; arithmetic shifts floor, as the reference's do."""
    Yh = Y >> _SPLIT
    Yl = Y & ((1 << _SPLIT) - 1)
    return wrap32(wmul(A, Yh).to(torch.int64) + (wmul(A, Yl) >> _SPLIT))


def recip_poly_fx(X: torch.Tensor, k1: float = K1_OPT,
                  k2: float = K2_OPT) -> torch.Tensor:
    """Algorithm 1 in int32 fixed point: X = x*2^14, x in [0.5, 1) ->
    y0 = 4*(k2 - x*(k1-x))*(k1-x) at 28 frac bits."""
    K1q, K2q = k_fixed(k1, k2)
    X = torch.as_tensor(X).to(torch.int32)
    B = K1q - X                                   # 14f
    C = wmul(X, B)                                # 28f
    D = wrap32(K2q - C.to(torch.int64))           # 28f
    E = _mul_y(B, D)                              # 28f
    return wrap32(E.to(torch.int64) << 2)


def nr_round_fx(Y: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """One Newton-Raphson round y <- y*(2 - x*y) in fixed point (Y 28f,
    X 14f); U = 2 - T is split at 14 bits, Uh arithmetic-shifted."""
    mask = (1 << _SPLIT) - 1
    T = _mul_y(X, Y)
    U = wrap32((2 << _YF) - T.to(torch.int64))
    hi = _mul_y(U >> _SPLIT, Y)
    lo = wmul(U & mask, Y >> _SPLIT) >> _SPLIT
    return wrap32(hi.to(torch.int64) + lo)


def approx_quotient(Ma: torch.Tensor, Mb: torch.Tensor, cfg: PositConfig, *,
                    mode: str, nr_rounds: int, wq: int,
                    k1: float = K1_OPT, k2: float = K2_OPT) -> torch.Tensor:
    """Integer quotient mantissa q ~= (Ma << (wq+1)) / Mb, clipped to
    [1, 2^(wq+2)].  Ma, Mb: decoded significands in [2^Wd, 2^(Wd+1))."""
    Wd = work_frac_bits(cfg)
    if mode in ("poly", "poly_corrected"):
        X = Mb << (13 - Wd)                       # x = m_b/2 at 14f
        Y = recip_poly_fx(X, k1, k2)
        for _ in range(nr_rounds):
            Y = nr_round_fx(Y, X)
        q = _mul_y(Ma, Y) >> (_YF - _SPLIT - (wq - Wd))
    elif mode == "pacogen":
        frac = Mb - (1 << Wd)
        Y = pacogen_lut_i32(frac, cfg) << (_YF - PACOGEN_LUT_OUT)
        X2 = Mb << (14 - Wd)                      # m_b in [1, 2) at 14f
        for _ in range(nr_rounds):
            Y = nr_round_fx(Y, X2)
        q = _mul_y(Ma, Y) >> (_YF - _SPLIT - (wq + 1 - Wd))
    else:
        raise ValueError(f"unknown division mode {mode!r}")
    return torch.clamp(q, 1, 1 << (wq + 2))


# ---- paper eq. (12)-(13): the k1/k2 optimization (numpy) ------------------
def squared_rel_err(k1: float, k2: float, num_pts: int = 20001) -> float:
    """e^2(k1,k2) = integral over (1/2, 1) of ((y - 1/x)*x)^2 dx  (eq. 12)."""
    x = np.linspace(0.5, 1.0, num_pts)
    y = 4.0 * (k2 - x * (k1 - x)) * (k1 - x)
    rerr = y * x - 1.0
    return float(np.trapezoid(rerr * rerr, x))


def optimize_k1_k2(iters: int = 200) -> tuple[float, float, float]:
    """Re-derive (k1_opt, k2_opt) by Newton descent on eq. (13)."""
    k = np.array([1.45, 1.0])
    h = 1e-6

    def f(v):
        return squared_rel_err(v[0], v[1])

    for _ in range(iters):
        g = np.array([
            (f(k + [h, 0]) - f(k - [h, 0])) / (2 * h),
            (f(k + [0, h]) - f(k - [0, h])) / (2 * h),
        ])
        H = np.zeros((2, 2))
        for i in range(2):
            for j in range(2):
                ei = np.eye(2)[i] * h
                ej = np.eye(2)[j] * h
                H[i, j] = (f(k + ei + ej) - f(k + ei - ej)
                           - f(k - ei + ej) + f(k - ei - ej)) / (4 * h * h)
        step = np.linalg.solve(H, g)
        k = k - step
        if np.max(np.abs(step)) < 1e-12:
            break
    return float(k[0]), float(k[1]), squared_rel_err(k[0], k[1])
