"""K2: the posit GEMM with in-kernel decode (``csrc/posit_gemm.cu``).

`posit_gemm` replaces ``repro/kernels/posit_gemm.py::posit_gemm`` (:87; its
pallas_call at :139): posit or f32 operands, decoded to exact f32 as the
tiles are staged, an f32 accumulator (the quire analogue), and either f32
out or one RNE rounding to posit bits (`out_posit`: the quire's single
rounding).  `pw_gemm` is its f32-activation form (``::pw_gemm``, :158), the
serving path's linear and unembedding: a decode step (M = max_seqs rows)
is bound by reading the weights, a prefill chunk by f32 FFMA; the source
picks a skinny kernel for M <= 8 and a 64x64-tiled one above it.
`posit_gemm(transpose_a=True)` is the training backward's dW leg, dW =
X^T G with X stored [k, m]: the tiled kernel's A loader reads the stored
rows of k, so no transposed copy exists.  `pw_gemm` has no transpose_a,
as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import PositConfig
from repro_torch.kernels import build, ref


def pw_gemm_plain(x: torch.Tensor, w_bits: torch.Tensor, cfg: PositConfig,
                  transpose_b: bool = False) -> torch.Tensor:
    pw_gemm_plain.calls += 1
    return ref.posit_gemm_ref(x, w_bits, cfg_a=None, cfg_b=cfg,
                              transpose_b=transpose_b)


def pw_gemm(x: torch.Tensor, w_bits: torch.Tensor, cfg: PositConfig, *,
            transpose_b: bool = False, transpose_a: bool = False,
            out_posit: bool = False) -> torch.Tensor:
    """x [m, k] f32 @ posit w [k, n] -> [m, n] f32; with transpose_b, w is
    stored [n, k] and contracted on its last axis, with no transposed copy.
    """
    if transpose_a or out_posit:
        raise NotImplementedError("pw_gemm is the f32-out form of the "
                                  "forward: posit bits out and transpose_a "
                                  "go through posit_gemm")
    if x.device.type == "cpu":
        return pw_gemm_plain(x, w_bits, cfg, transpose_b)
    lib = build.library("posit_gemm")
    if w_bits.dtype not in (torch.int8, torch.int16) or \
            w_bits.dtype != getattr(torch, cfg.storage_dtype_name):
        raise TypeError(f"pw_gemm: {cfg} weights must be "
                        f"{cfg.storage_dtype_name}, got {w_bits.dtype}")
    if x.dtype != torch.float32:
        raise TypeError(f"pw_gemm: activations must be float32, got {x.dtype}")
    x = x.contiguous()
    w_bits = w_bits.contiguous()
    build.check_cuda_tensors("pw_gemm", x, w_bits)
    M, K = x.shape
    N, K2 = w_bits.shape if transpose_b else w_bits.shape[::-1]
    if K != K2:
        raise ValueError(f"pw_gemm: x {tuple(x.shape)} and w "
                         f"{tuple(w_bits.shape)} (transpose_b={transpose_b}) "
                         f"do not contract")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    rc = lib.posit_pw_gemm(x.data_ptr(), w_bits.data_ptr(), out.data_ptr(),
                           M, N, K, int(transpose_b),
                           build.DTYPE_CODE[w_bits.dtype], cfg.n, cfg.es,
                           build.stream(x))
    pw_gemm.launches += 1
    build.check_launch(rc, "posit_pw_gemm")
    return out


def posit_gemm_plain(a, b, *, cfg_a: PositConfig | None,
                     cfg_b: PositConfig | None,
                     cfg_out: PositConfig | None = None,
                     out_posit: bool = False, transpose_a: bool = False,
                     transpose_b: bool = False) -> torch.Tensor:
    posit_gemm_plain.calls += 1
    return ref.posit_gemm_ref(a, b, cfg_a=cfg_a, cfg_b=cfg_b, cfg_out=cfg_out,
                              out_posit=out_posit, transpose_a=transpose_a,
                              transpose_b=transpose_b)


def _operand(name: str, t: torch.Tensor, cfg: PositConfig | None):
    """-> (contiguous tensor, dtype code, n, es); float32 when cfg is None,
    else the format's storage ints."""
    want = (torch.float32 if cfg is None
            else getattr(torch, cfg.storage_dtype_name))
    if cfg is not None and cfg.n > 16:
        raise NotImplementedError(f"posit_gemm: {cfg}: the kernel covers "
                                  f"n <= 16")
    if t.dtype != want:
        raise TypeError(f"posit_gemm: {name} must be {want} "
                        f"({cfg or 'float'}), got {t.dtype}")
    n, es = (cfg.n, cfg.es) if cfg is not None else (0, 0)
    return t.contiguous(), build.DTYPE_CODE[want], n, es


def posit_gemm(a: torch.Tensor, b: torch.Tensor, *,
               cfg_a: PositConfig | None, cfg_b: PositConfig | None,
               cfg_out: PositConfig | None = None, out_posit: bool = False,
               transpose_a: bool = False,
               transpose_b: bool = False) -> torch.Tensor:
    """a [m, k] @ b [k, n] with posit operands decoded in the kernel; a
    stored [k, m] (transpose_a) or b stored [n, k] (transpose_b) is
    contracted on its k axis in place.  cfg None means that operand is
    float32.  Returns the f32 accumulator, or its posit bits of cfg_out
    (one RNE rounding) when out_posit."""
    if out_posit and cfg_out is None:
        raise ValueError("posit_gemm: out_posit needs cfg_out")
    if a.device.type == "cpu":
        return posit_gemm_plain(a, b, cfg_a=cfg_a, cfg_b=cfg_b,
                                cfg_out=cfg_out, out_posit=out_posit,
                                transpose_a=transpose_a,
                                transpose_b=transpose_b)
    lib = build.library("posit_gemm")
    a, dta, na, esa = _operand("a", a, cfg_a)
    b, dtb, nb, esb = _operand("b", b, cfg_b)
    build.check_cuda_tensors("posit_gemm", a, b)
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"posit_gemm: operands must be 2-D, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    M, K = a.shape[::-1] if transpose_a else a.shape
    N, K2 = b.shape if transpose_b else b.shape[::-1]
    if K != K2:
        raise ValueError(f"posit_gemm: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} (transpose_a={transpose_a}, "
                         f"transpose_b={transpose_b}) do not contract")
    odt = (getattr(torch, cfg_out.storage_dtype_name) if out_posit
           else torch.float32)
    no, eso = (cfg_out.n, cfg_out.es) if out_posit else (0, 0)
    out = torch.empty((M, N), dtype=odt, device=a.device)
    if M == 0 or N == 0:
        return out
    rc = lib.posit_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                        int(transpose_a), int(transpose_b), dta, na, esa,
                        dtb, nb, esb, build.DTYPE_CODE[odt], no, eso,
                        build.stream(a))
    posit_gemm.launches += 1
    posit_gemm.transpose_a_launches += int(transpose_a)
    build.check_launch(rc, "posit_gemm")
    return out


pw_gemm.launches = 0
posit_gemm.launches = 0
posit_gemm.transpose_a_launches = 0     # the dW leg, counted in both
pw_gemm_plain.calls = 0
posit_gemm_plain.calls = 0
