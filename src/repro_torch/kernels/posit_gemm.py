"""K2: the posit GEMM with in-kernel decode (``csrc/posit_gemm.cu``).

`posit_gemm` replaces ``repro/kernels/posit_gemm.py::posit_gemm`` (:87; its
pallas_call at :139): posit or f32 operands, decoded to exact f32 as the
tiles are staged, an f32 accumulator (the quire analogue), and either f32
out or one RNE rounding to posit bits (`out_posit`: the quire's single
rounding).  `pw_gemm` is its f32-activation form (``::pw_gemm``, :158), the
serving path's linear and unembedding.  A decode step (M <= 8 rows) runs the
skinny kernel, bound by reading the weights: 16-byte weight loads, a decode
specialised per format (a shared table for posit8, a table and one rotation
for posit16 es 2), x staged in shared memory, and a k-split over a
thread-block cluster where column tiles alone leave SMs idle; `skinny_plan`
mirrors its launch plan.  Every other call runs the tiled tensor-core
kernel: each decoded operand element is split exactly
into bf16 pieces (two for a posit with n <= 16, three for an f32) and
their products, exact in bf16 x bf16 -> f32 `mma.sync`, are summed in f32;
f32 x f32 keeps 6 of the 9 piece products, which moves a result by at
most 2^-22 (|a| @ |b|) (derived in the source).  Its bound is bf16 tensor
work (4 or 6 products per f32 product at 989 TFLOP/s), or bytes at small
M.  `gemm_plan` mirrors the source's launch plan (tile, split-K slices,
threads, shared bytes); the wrappers pass it in and the kernel refuses any
other.  When the output tiles leave the last wave of SMs mostly idle and K
is long, K is split into slices summed by a second kernel in a fixed order
(no atomics), in an f32 workspace the wrapper allocates.  The plan counts
one block per SM: it picks the split that wastes the fewest rounds of
k-tiles to a partial last wave.
`posit_gemm(transpose_a=True)` is the training backward's dW leg, dW =
X^T G with X stored [k, m]; transposed operands are read through
`ldmatrix.trans`, so no transposed copy exists.  `pw_gemm` has no
transpose_a, as in the reference.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.types import PositConfig
from repro_torch.kernels import build, ref

# The plan constants of csrc/posit_gemm.cu (H100 SXM: 132 SMs).
SMS = 132
BK = 32                        # k per tile
PAD = 8                        # bf16 elements of padding per shared row
STAGES = 2
MAX_SPLITS = 8
MIN_SLICE_TILES = 4            # k-tiles a split-K slice keeps
# (BM, BN, warps along m, warps along n), largest first
TILES = ((128, 128, 2, 4), (64, 64, 2, 2))
SKINNY_M = 8                   # pw_gemm at M <= 8 runs the skinny kernel
PIECES = {"f32": 3, "posit": 2}   # bf16 pieces per operand element
# The skinny plan's constants (csrc/posit_gemm.cu, kSk*)
SK_THREADS = 256
SK_MAX_CLUSTER = 8             # the portable thread-block cluster size
SK_XS_BYTES = 32 * 1024        # x staged per k-chunk, at most
SK_TAB_BYTES = 256 * 4         # the static decode table
SK_SMEM_SM = 233_472           # shared bytes of an SM
SK_SMEM_BLOCK = 232_448        # ... that one block may use
SK_RESERVE = 1024              # the system's share per block
SK_TILE_COST = 8192            # a tile's fixed cost, in elements streamed
SK_CLUSTER_COST = 8192         # ... more with a cluster's syncs
SK_STEP_LOADS = {False: 2, True: 4}   # 16-byte loads of a lane's step
SK_STAGES = {False: 4, True: 3}       # steps in flight (the cp.async ring)
SK_TN = {False: (32, 16, 8, 4, 2),    # w [K, N]: lanes along n
         True: (64, 32, 16, 8)}       # w [N, K]: column groups of 4


class GemmPlan(NamedTuple):
    bm: int
    bn: int
    bk: int
    stages: int
    splits: int                # split-K slices (1: none)
    per: int                   # k-tiles per slice
    threads: int
    smem: int                  # dynamic shared bytes


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemm_plan(M: int, N: int, K: int, kinds=("f32", "f32"),
              transpose_a: bool = False,
              transpose_b: bool = False) -> GemmPlan:
    """Launch plan of the tiled tensor-core kernel for an [M, K] x [K, N]
    product whose operands are of `kinds` ("f32" or "posit" each), as
    ``csrc/posit_gemm.cu::make_plan`` computes it.  Per tile, largest
    first: the split S (1, or 2..8 slices of at least MIN_SLICE_TILES
    k-tiles, considered while the tiles fill under two waves) that takes
    the fewest rounds of k-tiles on the SMs at one block each,
    ceil(tiles S / SMS) * ceil(nk / S), where a split must save at least a
    tenth; the tile is kept if its blocks are busy at least 3/4 of that
    time, and the smallest tile regardless.  No slice is empty."""
    pa, pb = PIECES[kinds[0]], PIECES[kinds[1]]
    nk = cdiv(max(K, 1), BK)
    for i, (bm, bn, wm, wn) in enumerate(TILES):
        tiles = cdiv(M, bm) * cdiv(N, bn)
        cost1 = best = cdiv(tiles, SMS) * nk
        splits, per = 1, nk
        if tiles < 2 * SMS:
            for s in range(2, min(MAX_SPLITS, nk // MIN_SLICE_TILES) + 1):
                p = cdiv(nk, s)
                se = cdiv(nk, p)
                c = cdiv(tiles * se, SMS) * p
                if c < best and 10 * c <= 9 * cost1:
                    best, splits, per = c, se, p
        if 4 * tiles * nk >= 3 * SMS * best or i == len(TILES) - 1:
            break
    return GemmPlan(bm, bn, BK, STAGES, splits, per, wm * wn * 32,
                    mma_smem(bm, bn, pa, pb, transpose_a, transpose_b))


def mma_smem(bm: int, bn: int, pa: int, pb: int, ta: bool, tb: bool) -> int:
    """Dynamic shared bytes of the tensor-core k-loop's two stages of bf16
    planes (``csrc/gemm_pieces.cuh::mma_smem``): pa / pb pieces of A (TA:
    stored [k][m]) and B (TB: stored [n][k]), rows padded by PAD."""
    a_rows, a_cols = (BK, bm) if ta else (bm, BK)
    b_rows, b_cols = (bn, BK) if tb else (BK, bn)
    return 2 * STAGES * (pa * a_rows * (a_cols + PAD)
                         + pb * b_rows * (b_cols + PAD))


class SkinnyPlan(NamedTuple):
    bm: int                    # rows padded in shared memory: 4 or 8
    bn: int                    # columns a tile
    splits: int                # k-split over a cluster of this many blocks
    threads: int
    smem: int                  # dynamic shared bytes
    tn: int                    # lanes along n (column groups with transpose_b)
    tk: int                    # lanes along k
    kpg: int                   # k a group (one 16-byte load along k, or 1)
    per: int                   # k-groups a rank
    chunk: int                 # k-groups of one staged x chunk
    nch: int                   # chunks
    tiles: int
    grid: int                  # blocks: splits x clusters, persistent


@functools.lru_cache(maxsize=None)
def skinny_plan(M: int, N: int, K: int, transpose_b: bool = False,
                elem_bytes: int = 2) -> SkinnyPlan:
    """Launch plan of the skinny kernel (M <= 8) for x [M, K] times posit
    weights of `elem_bytes` bytes, as ``csrc/posit_gemm.cu::
    make_skinny_plan`` computes it.  For each column tile (tn, widest first)
    and cluster size cs (1..8, no rank without k): the ranks take cs equal
    slices of the k-groups, x is staged in chunks of at most 32 KB, and
    blocks loop over the tiles, as many as the SMs hold at once (by shared
    memory, and by registers: see `reg_bps`); a cluster takes one tile.
    Cost: rounds of tiles x (the slice x the tile width + each chunk's
    fixed cost: its first loads' latency and its sums, and a cluster's two
    syncs); the cheapest plan wins, the first of equals."""
    mp = 4 if M <= 4 else 8
    ve = 16 // elem_bytes
    cpt, kpg = (4, ve) if transpose_b else (ve, 1)
    ng = cdiv(max(K, 1), kpg)
    xs_groups = SK_XS_BYTES // (4 * kpg * mp)
    # by registers: one block an SM past 64 accumulators a lane, and for
    # [N, K] weights at 8 rows (they spilled at 128 registers)
    reg_bps = 1 if mp * cpt > 64 or (transpose_b and mp == 8) else 2
    best, best_cost = None, -1
    for tn in SK_TN[transpose_b]:
        tk, bn = SK_THREADS // tn, tn * cpt
        tiles = cdiv(N, bn)
        for cs in range(1, SK_MAX_CLUSTER + 1):
            per = cdiv(ng, cs)
            if cdiv(ng, per) != cs:
                continue
            chunk = min(per, xs_groups)
            red = 4 * (tk // 2) * (mp * bn + 4)
            cred = 4 * cs * mp * bn if cs > 1 else 0
            ring = 16 * SK_STAGES[transpose_b] * SK_STEP_LOADS[
                transpose_b] * SK_THREADS
            smem = 4 * chunk * kpg * mp + max(red, cred) + ring
            if smem + SK_TAB_BYTES > SK_SMEM_BLOCK:
                continue
            bps = min(reg_bps, SK_SMEM_SM // (smem + SK_TAB_BYTES
                                              + SK_RESERVE))
            groups = min(tiles, max(1, SMS * bps // cs))
            if cs > 1 and groups < tiles:
                continue                 # a cluster takes one tile
            nch = cdiv(per, chunk)
            cost = cdiv(tiles, groups) * (
                per * kpg * bn + nch * (SK_TILE_COST + (SK_CLUSTER_COST
                                                        if cs > 1 else 0)))
            if best is None or cost < best_cost:
                best_cost = cost
                best = SkinnyPlan(mp, bn, cs, SK_THREADS, smem, tn, tk, kpg,
                                  per, chunk, nch, tiles, groups * cs)
    return best


def _plan_args(plan: GemmPlan, M: int, N: int, device):
    """-> (the split-K workspace or None, the C entry's workspace pointer
    and plan ints)."""
    ws = (torch.empty((plan.splits, M, N), dtype=torch.float32,
                      device=device) if plan.splits > 1 else None)
    return ws, (ws.data_ptr() if ws is not None else None, plan.bm,
                plan.bn, plan.splits, plan.threads, plan.smem)


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
    if M <= SKINNY_M:
        plan = skinny_plan(M, N, K, transpose_b, w_bits.element_size())
        ws, args = None, (None, plan.bm, plan.bn, plan.splits, plan.threads,
                          plan.smem)
    else:
        plan = gemm_plan(M, N, K, ("f32", "posit"), False, transpose_b)
        ws, args = _plan_args(plan, M, N, x.device)
    rc = lib.posit_pw_gemm(x.data_ptr(), w_bits.data_ptr(), out.data_ptr(),
                           M, N, K, int(transpose_b),
                           build.DTYPE_CODE[w_bits.dtype], cfg.n, cfg.es,
                           *args, build.stream(x))
    pw_gemm.launches += 1
    pw_gemm.reduce_launches += int(ws is not None)
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
    kinds = tuple("f32" if c is None else "posit" for c in (cfg_a, cfg_b))
    plan = gemm_plan(M, N, K, kinds, transpose_a, transpose_b)
    ws, args = _plan_args(plan, M, N, a.device)
    rc = lib.posit_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                        int(transpose_a), int(transpose_b), dta, na, esa,
                        dtb, nb, esb, build.DTYPE_CODE[odt], no, eso,
                        *args, build.stream(a))
    posit_gemm.launches += 1
    posit_gemm.transpose_a_launches += int(transpose_a)
    posit_gemm.reduce_launches += int(plan.splits > 1)
    build.check_launch(rc, "posit_gemm")
    return out


pw_gemm.launches = 0
posit_gemm.launches = 0
posit_gemm.transpose_a_launches = 0     # the dW leg, counted in both
# launches of the split-K reduce that followed a tiled launch
pw_gemm.reduce_launches = 0
posit_gemm.reduce_launches = 0
pw_gemm_plain.calls = 0
posit_gemm_plain.calls = 0
