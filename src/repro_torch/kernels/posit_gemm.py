"""K2: f32 activations x posit weights -> f32 (``csrc/posit_gemm.cu``).

Replaces ``repro/kernels/posit_gemm.py::pw_gemm`` (:158; the pallas_call of
``posit_gemm`` at :139).  A decode step (M = max_seqs rows) is bound by
reading the weights, a prefill chunk by f32 FFMA; the source picks a
skinny kernel for M <= 8 and a 64x64-tiled one above it.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import PositConfig
from repro_torch.kernels import build, ref


def pw_gemm_plain(x: torch.Tensor, w_bits: torch.Tensor, cfg: PositConfig,
                  transpose_b: bool = False) -> torch.Tensor:
    pw_gemm_plain.calls += 1
    return ref.posit_gemm_ref(x, w_bits, cfg, transpose_b)


def pw_gemm(x: torch.Tensor, w_bits: torch.Tensor, cfg: PositConfig, *,
            transpose_b: bool = False, transpose_a: bool = False,
            out_posit: bool = False) -> torch.Tensor:
    """x [m, k] f32 @ posit w [k, n] -> [m, n] f32; with transpose_b, w is
    stored [n, k] and contracted on its last axis, with no transposed copy.
    """
    if transpose_a or out_posit:
        raise NotImplementedError("pw_gemm: transpose_a and out_posit are "
                                  "not ported yet")
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


pw_gemm.launches = 0
pw_gemm_plain.calls = 0
