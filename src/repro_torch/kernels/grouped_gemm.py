"""K10 and K11: the grouped posit GEMM of the MoE block and its dW
(``csrc/grouped_gemm.cu``).

`posit_grouped_gemm` replaces ``repro/kernels/grouped_gemm.py::
posit_grouped_gemm`` (:146; its pallas_call at :212): expert-sorted rows
x [S, k] times their own group's weight w[g] [k, n], posit tiles decoded
to exact f32 as they are staged, f32 accumulation; rows outside
[offsets[0], offsets[E]) come back exactly 0.  With transpose_b, w is
stored [E, n, k] (or the same [E, k, n] storage read as the backward's
dX = G W^T).  `posit_grouped_gemm_dw` replaces ``::posit_grouped_gemm_dw``
(:272; pallas_call at :314): dw[e] = x[rows(e)]^T g[rows(e)], 0 for an
empty group.  The offsets stay on the device: nothing here reads them on
the host (the plain versions do, for CPU tensors).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import PositConfig
from repro_torch.kernels import build, ref


def posit_grouped_gemm_plain(x, w, group_offsets, cfg: PositConfig | None,
                             transpose_b: bool = False) -> torch.Tensor:
    posit_grouped_gemm_plain.calls += 1
    return ref.grouped_matmul_ref(x, w, group_offsets, cfg_b=cfg,
                                  transpose_b=transpose_b)


def posit_grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                       group_offsets: torch.Tensor,
                       cfg: PositConfig | None = None, *,
                       transpose_b: bool = False) -> torch.Tensor:
    """x [S, k] f32 @ w[g(r)] -> [S, n] f32 for rows r of group g; w is
    [E, k, n] (or [E, n, k] with transpose_b), posit storage ints of `cfg`
    or float32 when cfg is None; group_offsets [E+1] int32, nondecreasing."""
    if x.device.type == "cpu":
        return posit_grouped_gemm_plain(x, w, group_offsets, cfg,
                                        transpose_b)
    lib = build.library("grouped_gemm")
    want = (torch.float32 if cfg is None
            else getattr(torch, cfg.storage_dtype_name))
    if cfg is not None and cfg.n > 16:
        raise NotImplementedError(f"posit_grouped_gemm: {cfg}: the kernel "
                                  f"covers n <= 16")
    if w.dtype != want:
        raise TypeError(f"posit_grouped_gemm: w must be {want} "
                        f"({cfg or 'float'}), got {w.dtype}")
    if x.dtype != torch.float32:
        raise TypeError(f"posit_grouped_gemm: x must be float32, got "
                        f"{x.dtype}")
    x, w = x.contiguous(), w.contiguous()
    off = group_offsets.to(torch.int32).contiguous()
    build.check_cuda_tensors("posit_grouped_gemm", x, w, off)
    if x.ndim != 2 or w.ndim != 3 or off.ndim != 1:
        raise ValueError(f"posit_grouped_gemm: want x [S, k], w [E, k, n], "
                         f"offsets [E+1]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(off.shape)}")
    S, K = x.shape
    E = w.shape[0]
    N, K2 = (w.shape[1], w.shape[2]) if transpose_b else (w.shape[2],
                                                          w.shape[1])
    if K != K2 or off.shape[0] != E + 1:
        raise ValueError(f"posit_grouped_gemm: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} (transpose_b={transpose_b}) and "
                         f"offsets {tuple(off.shape)} do not fit")
    out = torch.zeros((S, N), dtype=torch.float32, device=x.device)
    if S == 0 or N == 0 or E == 0:
        return out
    n, es = (cfg.n, cfg.es) if cfg is not None else (0, 0)
    rc = lib.posit_grouped_gemm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                off.data_ptr(), S, N, K, E, int(transpose_b),
                                build.DTYPE_CODE[want], n, es,
                                build.stream(x))
    posit_grouped_gemm.launches += 1
    posit_grouped_gemm.transpose_b_launches += int(transpose_b)
    build.check_launch(rc, "posit_grouped_gemm")
    return out


def posit_grouped_gemm_dw_plain(x, g, group_offsets) -> torch.Tensor:
    posit_grouped_gemm_dw_plain.calls += 1
    return ref.grouped_matmul_dw_ref(x, g, group_offsets)


def posit_grouped_gemm_dw(x: torch.Tensor, g: torch.Tensor,
                          group_offsets: torch.Tensor) -> torch.Tensor:
    """dw[e] = x[rows(e)]^T g[rows(e)]: x [S, k] f32, g [S, n] f32 ->
    [E, k, n] f32 with E = len(group_offsets) - 1."""
    if x.device.type == "cpu":
        return posit_grouped_gemm_dw_plain(x, g, group_offsets)
    lib = build.library("grouped_gemm")
    if x.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"posit_grouped_gemm_dw: x and g must be float32, "
                        f"got {x.dtype} and {g.dtype}")
    x, g = x.contiguous(), g.contiguous()
    off = group_offsets.to(torch.int32).contiguous()
    build.check_cuda_tensors("posit_grouped_gemm_dw", x, g, off)
    if x.ndim != 2 or g.ndim != 2 or x.shape[0] != g.shape[0] \
            or off.ndim != 1:
        raise ValueError(f"posit_grouped_gemm_dw: want x [S, k], g [S, n], "
                         f"offsets [E+1]; got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}, {tuple(off.shape)}")
    S, M = x.shape
    N = g.shape[1]
    E = off.shape[0] - 1
    dw = torch.empty((E, M, N), dtype=torch.float32, device=x.device)
    if E <= 0 or M == 0 or N == 0:
        return dw
    rc = lib.posit_grouped_gemm_dw(x.data_ptr(), g.data_ptr(), dw.data_ptr(),
                                   off.data_ptr(), S, M, N, E,
                                   build.stream(x))
    posit_grouped_gemm_dw.launches += 1
    build.check_launch(rc, "posit_grouped_gemm_dw")
    return dw


posit_grouped_gemm.launches = 0
posit_grouped_gemm.transpose_b_launches = 0   # the dX leg, counted in both
posit_grouped_gemm_dw.launches = 0
posit_grouped_gemm_plain.calls = 0
posit_grouped_gemm_dw_plain.calls = 0
