"""K10 and K11: the grouped posit GEMM of the MoE block and its dW
(``csrc/grouped_gemm.cu``).

`posit_grouped_gemm` replaces ``repro/kernels/grouped_gemm.py::
posit_grouped_gemm`` (:146; its pallas_call at :212): expert-sorted rows
x [S, k] times their own group's weight w[g] [k, n], f32 accumulation;
rows outside [offsets[0], offsets[E]) come back exactly 0.  With
transpose_b, w is stored [E, n, k] (or the same [E, k, n] storage read as
the backward's dX = G W^T).  `posit_grouped_gemm_dw` replaces
``::posit_grouped_gemm_dw`` (:272; pallas_call at :314): dw[e] =
x[rows(e)]^T g[rows(e)], 0 for an empty group.  The offsets stay on the
device: nothing here reads them on the host (the plain versions do, for
CPU tensors).

`grouped_plan` mirrors the source's launch plan, cached per shape: posit
weights at fewer than 16 rows a group on average (S < 16 E, every decode
step) take the decode form, which streams each active expert's table once
per chunk of at most 8 rows with K2's skinny tools (a decode per format,
16-byte cp.async loads, x in shared memory) and FFMA; every other call
takes the tiled form, bf16 `mma.sync` on exact bf16 pieces as K2's tiled
form (three per f32, two per posit; f32 x f32 keeps 6 of the 9 products,
a declared 2^-22 (|a| @ |b|)), 128 x 128 tiles from 128 rows a group on
average, else 64 x 64.  K11 runs the tiled form on x^T g with the group's
rows as k.  The wrappers pass the plan in and the kernels refuse any other.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.types import PositConfig
from repro_torch.kernels import build, ref
from repro_torch.kernels.posit_gemm import (SK_STEP_LOADS, SK_STAGES,
                                            SK_THREADS, SK_XS_BYTES, TILES,
                                            cdiv, mma_smem)

# The plan constants of csrc/grouped_gemm.cu
STREAM_ROWS = 16               # S < 16 E (posit weights): the decode form
STREAM_BM = 8                  # a group's rows a pass of the decode form
STREAM_BN = 128                # its columns a block
BIG_TILE_ROWS = 128            # S >= 128 E: 128 x 128 tiles, else 64 x 64
FORMS = {"stream": 0, "mma": 1}  # the C entry's form codes


class GroupedPlan(NamedTuple):
    form: str                  # "stream" (decode) or "mma" (tiled)
    bm: int                    # rows a tile (stream: a group's rows a pass)
    bn: int                    # columns a block
    threads: int
    smem: int                  # dynamic shared bytes
    tn: int                    # stream: lanes (column groups) along n
    tk: int                    # stream: lanes along k
    chunk: int                 # stream: k-groups of one staged x chunk
    nch: int                   # stream: chunks


def _mma_plan(bm: int, bn: int, smem: int) -> GroupedPlan:
    wm, wn = [(t[2], t[3]) for t in TILES if (t[0], t[1]) == (bm, bn)][0]
    return GroupedPlan("mma", bm, bn, wm * wn * 32, smem, 0, 0, 0, 0)


@functools.lru_cache(maxsize=None)
def grouped_plan(S: int, N: int, K: int, E: int, elem_bytes: int = 2,
                 transpose_b: bool = False, dw: bool = False) -> GroupedPlan:
    """Launch plan of K10 for x [S, K] times E tables of `elem_bytes`-byte
    elements (4: f32, 2 or 1: posit) giving [S, N], or of K11 (`dw`: x [S,
    K] and g [S, N] f32), as ``csrc/grouped_gemm.cu::make_grouped_plan`` /
    ``make_dw_plan`` compute it.  Decode form (posit, S < 16 E): 256
    threads over 128 columns, 128 / (columns a lane) lanes along n and the
    rest along k, x staged in k-chunks of 32 KB at 8 rows, x and the
    k-lanes' partial sums sharing one region beside the cp.async ring.
    Tiled form: 128 x 128 tiles (256 threads) from S >= 128 E, else 64 x 64
    (128 threads), two stages of bf16 planes (three pieces for x and f32
    weights, two for posits)."""
    if dw:
        return _mma_plan(128, 128, mma_smem(128, 128, 3, 3, True, False))
    if elem_bytes != 4 and S < STREAM_ROWS * E:
        tb = transpose_b
        cpt, kpg = (4, 16 // elem_bytes) if tb else (16 // elem_bytes, 1)
        tn = STREAM_BN // cpt
        tk = SK_THREADS // tn
        ng = cdiv(max(K, 1), kpg)
        chunk = min(ng, SK_XS_BYTES // (4 * kpg * STREAM_BM))
        xs = 4 * chunk * kpg * STREAM_BM
        red = 4 * (tk // 2) * (STREAM_BM * STREAM_BN + 4)
        ring = 16 * SK_STAGES[tb] * SK_STEP_LOADS[tb] * SK_THREADS
        return GroupedPlan("stream", STREAM_BM, STREAM_BN, SK_THREADS,
                           max(xs, red) + ring, tn, tk, chunk,
                           cdiv(ng, chunk))
    bm = 128 if S >= BIG_TILE_ROWS * E else 64
    return _mma_plan(bm, bm, mma_smem(bm, bm, 3, 3 if elem_bytes == 4
                                       else 2, False, transpose_b))


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
    plan = grouped_plan(S, N, K, E, w.element_size(), transpose_b)
    rc = lib.posit_grouped_gemm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                off.data_ptr(), S, N, K, E, int(transpose_b),
                                build.DTYPE_CODE[want], n, es,
                                FORMS[plan.form], plan.bm, plan.bn,
                                plan.threads, plan.smem, build.stream(x))
    posit_grouped_gemm.launches += 1
    posit_grouped_gemm.transpose_b_launches += int(transpose_b)
    posit_grouped_gemm.stream_launches += int(plan.form == "stream")
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
    plan = grouped_plan(S, N, M, E, dw=True)
    rc = lib.posit_grouped_gemm_dw(x.data_ptr(), g.data_ptr(), dw.data_ptr(),
                                   off.data_ptr(), S, M, N, E, plan.bm,
                                   plan.bn, plan.threads, plan.smem,
                                   build.stream(x))
    posit_grouped_gemm_dw.launches += 1
    build.check_launch(rc, "posit_grouped_gemm_dw")
    return dw


posit_grouped_gemm.launches = 0
posit_grouped_gemm.transpose_b_launches = 0   # the dX leg, counted in both
posit_grouped_gemm.stream_launches = 0   # the decode form, counted in both
posit_grouped_gemm_dw.launches = 0
posit_grouped_gemm_plain.calls = 0
posit_grouped_gemm_dw_plain.calls = 0
