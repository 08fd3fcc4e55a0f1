"""float32 <-> posit conversions, the paper's PFCVT instructions (§VI)."""
from __future__ import annotations

import torch

from repro_torch.core.decode import decode_to_f32
from repro_torch.core.encode import encode_fir, to_storage
from repro_torch.core.types import PositConfig


def f32_to_posit(v: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """Correctly rounded float32 -> posit storage ints.

    RNE; NaN/Inf -> NaR; +-0 -> 0; subnormals saturate to +-minpos.  Torch
    ``>>`` on int32 is arithmetic, as jnp's is.
    """
    if cfg.n > 16:
        raise NotImplementedError(f"{cfg}: the port's codec covers n <= 16")
    i = v.to(torch.float32).contiguous().view(torch.int32)
    s = (i >> 31) & 1
    exp = (i >> 23) & 0xFF
    mant = i & 0x7FFFFF
    nar = exp == 0xFF
    zero = (i & 0x7FFFFFFF) == 0
    W = 23
    te = torch.where(exp == 0, -200, exp - 127)
    M = (1 << W) | mant
    out = encode_fir(s, te, M, W, torch.zeros_like(M), cfg)
    out = torch.where(zero, 0, out)
    out = torch.where(nar, cfg.nar, out)
    return to_storage(out, cfg)


def posit_to_f32(p: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """Exact posit -> float32 (PFCVT.S); NaR -> NaN."""
    return decode_to_f32(p, cfg)


def bf16_to_posit(v: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    return f32_to_posit(v.to(torch.float32), cfg)


def f32_to_bf16(v: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16 with NaN as the quiet NaN 0x7FC0, as XLA gives it
    (torch's vectorized CPU cast gives 0xFFFF)."""
    nan = torch.full((), 0x7FC0, dtype=torch.int16,
                     device=v.device).view(torch.bfloat16)
    return torch.where(torch.isnan(v), nan, v.to(torch.bfloat16))


def posit_to_bf16(p: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """posit -> bfloat16 (the f32 intermediate is exact for n <= 16, so the
    double rounding is innocuous); NaR -> NaN."""
    return f32_to_bf16(decode_to_f32(p, cfg))
