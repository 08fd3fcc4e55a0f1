"""K3: paged decode attention (``csrc/paged_attention.cu``); K4: paged
prefill attention, K7-K9: the contiguous flash prefill with its
log-sum-exp and its backward, and K14, the [BH, Sq, D] attention
(``csrc/flash_prefill.cu``).

`paged_flash_decode` replaces ``repro/kernels/flash_attention.py::
paged_flash_decode`` (:650), `paged_flash_prefill` replaces
``::paged_flash_prefill`` (:259), `flash_prefill_contiguous` replaces
``::flash_prefill_contiguous`` (:332) and `flash_prefill_bwd_contiguous`
``::flash_prefill_bwd_contiguous`` (:552), whose two passes are the
separately counted `flash_prefill_bwd_dq` and `flash_prefill_bwd_dkv`.
`flash_attention` (K14) replaces ``::flash_attention`` (:710; pallas_call
at :738): the same function as K7 with one kv head per query head,
kv_len = Skv and q_offset = Skv - Sq, so it launches K7's forward.

K3 splits each (sequence, kv head) into `decode_plan(...).splits`
contiguous ranges of the page table's pages, one block each, chosen from
host-known shapes only (never seq_lens) to fill the card; the block
streams its keys through a cp.async ring, warps on keys and lanes on
dimensions, and the ranges' partials meet in a thread-block cluster in
split order (`decode_plan` mirrors the source's plan; the C entry refuses
any other).  K4 is K7's register-tiled forward reading its keys through
the page table (`flash_fwd_paged_kernel`): 64 flat rows of the G heads of
a kv group a block, K/V tiles double-buffered, keys below the block's
window, past seq_lens or on an entry outside the pool staged as zeros,
so its geometry is `flash_geometry("fwd", D)`.  Rows that see no key
(l == 0) come back 0 from the kernels; the paged plain versions keep the
reference's -1e30 masking there, the contiguous ones give 0 as well.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.types import PositConfig
from repro_torch.kernels import build, ref

_MAX_SHARED = 232448          # a block's dynamic shared memory (opted in)

# K3's plan constants (csrc/paged_attention.cu, kDec*)
DEC_THREADS = 256             # a block's threads
DEC_VPL = 8                   # dimensions a lane holds
DEC_GH = 4                    # query heads a warp holds, at most
DEC_STAGES = 3                # ring stages: two in flight
DEC_STAGE_ELEMS = 4096        # K (and V) elements a stage aims at
DEC_MAX_SPLIT = 16            # cluster ranks (above 8: non-portable)
DEC_SMS = 132                 # H100 SXM
DEC_MAX_G = 32                # query heads a kv head, at most


class DecodePlan(NamedTuple):
    splits: int               # blocks (cluster ranks) a (sequence, kv head)
    pages_per_split: int      # table pages a split owns, at most
    stage_pages: int          # pages a ring stage holds
    head_groups: int          # warps split the G heads into this many
    streams: int              # (warp, key slot) streams of a head group
    stream_ml: int            # floats of the streams' m (and l): streams
                              # G rounded to 4
    smem: int                 # dynamic shared bytes


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def decode_plan(B: int, n_kv: int, W: int, page: int, D: int, G: int,
                elem_bytes: int) -> DecodePlan:
    """K3's launch plan, as ``csrc/paged_attention.cu::make_decode_plan``
    computes it from host-known shapes: S = min(16, W, ceil(132 / (B
    n_kv))) ranges of the table's pages, split s owning [s W // S,
    (s + 1) W // S) (`split_pages`); 256 threads a block; warps in 2^k
    head groups of at most 4 heads; ring stages of whole pages near 4,096
    elements of K; shared memory for the table slice, the stages' key
    masks, the raw ring and, above D = 128, a posit stage decoded once
    into f32 (or the streams' partials, their m and l each rounded to 4
    floats so that their acc stays 16-byte aligned, or the cluster's
    weights, which reuse them), and the block's partial."""
    dmax = 64 if D <= 64 else 128 if D <= 128 else 256
    kpw = 32 // (dmax // DEC_VPL)
    want = max(1, _cdiv(DEC_SMS, max(1, B * n_kv)))
    splits = min(DEC_MAX_SPLIT, W, want)
    hg = 1
    while hg * DEC_GH < G:
        hg *= 2
    nks = DEC_THREADS // 32 // hg * kpw
    psw = _cdiv(nks * G, 4) * 4
    pps = _cdiv(W, splits)
    sp = min(pps, max(1, DEC_STAGE_ELEMS // (page * D)))
    pt_words = _cdiv(pps, 4) * 4
    mask_words = _cdiv(DEC_STAGES * sp * page, 16) * 4
    ring = DEC_STAGES * 2 * sp * page * D * elem_bytes // 4
    # above D = 128 a posit stage is decoded once into f32
    tile = 0 if elem_bytes == 4 or D <= 128 else 2 * sp * page * D
    region = max(ring + tile, nks * G * D + 2 * psw, 3 * splits * G + G)
    smem = 4 * (pt_words + mask_words + region + G * D + 2 * G)
    return DecodePlan(splits, pps, sp, hg, nks, psw, smem)


def split_pages(s: int, splits: int, W: int) -> range:
    """The page-table columns split s of K3's plan owns."""
    return range(s * W // splits, (s + 1) * W // splits)


def _pool_dtype(k_pages, v_pages, cfg_kv):
    dt = (torch.float32 if cfg_kv is None
          else getattr(torch, cfg_kv.storage_dtype_name))
    if k_pages.dtype != dt or v_pages.dtype != dt:
        raise TypeError(f"pages must be {dt} for cfg_kv={cfg_kv}, got "
                        f"{k_pages.dtype}/{v_pages.dtype}")
    return dt


def _check_pools(fn, k_pages, v_pages):
    # the kernels copy page rows 16 bytes at a time; a pool is never copied
    if k_pages.shape != v_pages.shape or k_pages.ndim != 4:
        raise ValueError(f"{fn}: k and v pages must be [P, n_kv, page, D] "
                         f"alike")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{fn}: page pools must be 16-byte aligned")


def paged_flash_decode_plain(q, k_pages, v_pages, page_table, seq_lens, *,
                             cfg_kv: PositConfig | None = None, window=None):
    paged_flash_decode_plain.calls += 1
    return ref.paged_decode_ref(q, k_pages, v_pages, page_table, seq_lens,
                                cfg_kv=cfg_kv, window=window)


def paged_flash_decode(q, k_pages, v_pages, page_table, seq_lens, *,
                       cfg_kv: PositConfig | None = None, window=None):
    """q [B, H, D] over the paged pool -> [B, H, D] f32.

    The query sits at position seq_lens[b] - 1 (the cache is post-append);
    it sees kpos < seq_lens[b] and, with a window, kpos > seq_lens[b] - 1 -
    window.
    """
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pages, v_pages, page_table,
                                        seq_lens, cfg_kv=cfg_kv,
                                        window=window)
    lib = build.library("paged_attention")
    dt = _pool_dtype(k_pages, v_pages, cfg_kv)
    q = _aligned(q.to(torch.float32).contiguous())
    page_table = page_table.to(torch.int32).contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    build.check_cuda_tensors("paged_flash_decode", q, k_pages, v_pages,
                             page_table, seq_lens)
    B, H, D = q.shape
    P, n_kv, page, _ = k_pages.shape
    eb = k_pages.element_size()
    if (H % n_kv or D != k_pages.shape[3] or D % 4 or D > 256
            or (page * D * eb) % 16 or H // n_kv > DEC_MAX_G):
        raise ValueError("paged_flash_decode: needs H % n_kv == 0, D % 4 "
                         "== 0, D <= 256, 16-byte pages and at most "
                         f"{DEC_MAX_G} query heads per kv head")
    _check_pools("paged_flash_decode", k_pages, v_pages)
    W = page_table.shape[1]
    plan = decode_plan(B, n_kv, W, page, D, H // n_kv, eb)
    if plan.smem > _MAX_SHARED:
        raise ValueError(f"paged_flash_decode: {plan.smem} B of shared "
                         f"memory exceeds {_MAX_SHARED}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    n, es = (cfg_kv.n, cfg_kv.es) if cfg_kv is not None else (0, 0)
    rc = lib.posit_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), B, H,
        n_kv, page, D, W, P, 0 if window is None else int(window),
        float(D ** -0.5), build.DTYPE_CODE[dt], n, es, plan.splits,
        plan.smem, build.stream(q))
    paged_flash_decode.launches += 1
    build.check_launch(rc, "posit_paged_decode")
    return out


def paged_flash_prefill_plain(q, k_pages, v_pages, page_table, seq_lens,
                              q_offset, *, cfg_kv: PositConfig | None = None,
                              causal=True, window=None, softcap=None):
    paged_flash_prefill_plain.calls += 1
    return ref.paged_prefill_ref(q, k_pages, v_pages, page_table, seq_lens,
                                 q_offset, cfg_kv=cfg_kv, causal=causal,
                                 window=window, softcap=softcap)


def paged_flash_prefill(q, k_pages, v_pages, page_table, seq_lens, q_offset,
                        *, cfg_kv: PositConfig | None = None, causal=True,
                        window=None, softcap=None):
    """q [B, H, Sq, D] over the paged pool -> [B, H, Sq, D] f32.

    seq_lens [B] is the post-append length (keys at or past it are
    masked), q_offset [B] the absolute position of each sequence's first
    query row.  Rows past a sequence's real chunk are garbage for the
    caller to ignore.
    """
    if q.device.type == "cpu":
        return paged_flash_prefill_plain(
            q, k_pages, v_pages, page_table, seq_lens, q_offset,
            cfg_kv=cfg_kv, causal=causal, window=window, softcap=softcap)
    lib = build.library("flash_prefill")
    dt = _pool_dtype(k_pages, v_pages, cfg_kv)
    q = _aligned(q.to(torch.float32).contiguous())
    page_table = page_table.to(torch.int32).contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    q_offset = q_offset.to(torch.int32).contiguous()
    build.check_cuda_tensors("paged_flash_prefill", q, k_pages, v_pages,
                             page_table, seq_lens, q_offset)
    B, H, Sq, D = q.shape
    P, n_kv, page, _ = k_pages.shape
    if H % n_kv or D != k_pages.shape[3] or D % 4 or D > _MAX_D:
        raise ValueError("paged_flash_prefill: needs H % n_kv == 0, D % 4 "
                         f"== 0 and D <= {_MAX_D}")
    _check_pools("paged_flash_prefill", k_pages, v_pages)
    geo = flash_geometry("fwd", D)
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    n, es = (cfg_kv.n, cfg_kv.es) if cfg_kv is not None else (0, 0)
    rc = lib.flash_prefill_paged_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), q_offset.data_ptr(),
        out.data_ptr(), B, H, n_kv, Sq, page, D, page_table.shape[1], P,
        int(causal), _window(window), _softcap(softcap), float(D ** -0.5),
        build.DTYPE_CODE[dt], n, es, geo.threads, geo.shmem,
        build.stream(q))
    paged_flash_prefill.launches += 1
    build.check_launch(rc, "flash_prefill_paged_fwd")
    return out


# ---- K7-K9: the contiguous prefill and its backward ---------------------
_MAX_D = 256                  # every flash kernel (K7-K9, K14)


class Geometry(NamedTuple):
    threads: int
    shmem: int                # dynamic shared bytes


def _pad_ld(D):
    # an odd number of 16-byte chunks per row: 8 lanes reading 8 rows in
    # one float4 phase hit 8 different banks
    return D if (D // 4) % 2 else D + 4


def flash_geometry(kernel: str, D: int) -> Geometry:
    """Launch geometry of the register-tiled forward (`kernel="fwd"`, K7
    and K14: 64 flat query rows a block, K/V tiles of 64 keys, 32 above
    D = 64), dQ (`"dq"`, K8: the same rows, K/V tiles of 32 keys, 16
    above D = 64) or dK/dV (`"dkv"`, K9: 32 keys a block, Q/dO tiles of
    64 rows, 32 above D = 64) at head_dim D, mirroring
    ``csrc/flash_prefill.cu`` (whose entry points refuse any other).  K7
    and K8 fold the G query heads of a kv group into their row tiles and
    K9 sweeps them inside the block, so G does not change it."""
    if D <= 0 or D % 4 or D > _MAX_D:
        raise ValueError(f"head_dim {D}: the flash kernels take D % 4 == 0 "
                         f"and D <= {_MAX_D}")
    dmax = 64 if D <= 64 else 128 if D <= 128 else 256
    if kernel == "fwd":
        bn = 64 if dmax == 64 else 32
        return Geometry(256, 4 * (64 * D + 2 * bn * _pad_ld(D)
                                  + 2 * bn * D + bn * 68))
    if kernel == "dq":
        bn = 32 if dmax == 64 else 16
        return Geometry(256, 4 * (2 * 64 * D + 4 * bn * _pad_ld(D)
                                  + bn * 68))
    if kernel == "dkv":
        br = 64 if dmax == 64 else 32
        tx = 16 if dmax <= 128 else 32
        return Geometry(8 * tx, 4 * (2 * 32 * D + 4 * br * _pad_ld(D)
                                     + 2 * br * 36 + 4 * br))
    raise ValueError(f"unknown flash kernel {kernel!r}")


def _kv_dtype(k, v, cfg_kv):
    dt = (torch.float32 if cfg_kv is None
          else getattr(torch, cfg_kv.storage_dtype_name))
    if k.dtype != dt or v.dtype != dt:
        raise TypeError(f"k/v must be {dt} for cfg_kv={cfg_kv}, got "
                        f"{k.dtype}/{v.dtype}")
    return dt


def _check_prefill(fn, q, k, v, kv_len, q_offset):
    """Shapes the K7-K9 kernels take -> (B, H, n_kv, Sq, Skv, D): any
    H % n_kv == 0, D % 4 == 0 and D <= 256."""
    if q.dtype != torch.float32:
        raise TypeError(f"{fn}: q must be float32, got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{fn}: q [B,H,Sq,D] and k, v [B,n_kv,Skv,D] "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    _, n_kv, Skv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or n_kv == 0 or H % n_kv:
        raise ValueError(f"{fn}: needs matching B and D and H % n_kv == 0")
    if D % 4 or D > _MAX_D:
        raise ValueError(f"{fn}: head_dim {D}: needs D % 4 == 0; the "
                         f"kernel takes D <= {_MAX_D}")
    if kv_len.shape != (B,) or q_offset.shape != (B,):
        raise ValueError(f"{fn}: kv_len and q_offset must be [B] = [{B}]")
    return B, H, n_kv, Sq, Skv, D


def _aligned(t):
    # the kernels copy rows with 16-byte cp.async
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _window(window):
    return 0 if window is None else int(window)


def _softcap(softcap):
    return 0.0 if softcap is None else float(softcap)


def flash_prefill_contiguous_plain(q, k, v, kv_len, q_offset, *,
                                   cfg_kv: PositConfig | None = None,
                                   causal=True, window=None, softcap=None,
                                   return_lse=False):
    flash_prefill_contiguous_plain.calls += 1
    return ref.flash_prefill_ref(q, k, v, kv_len, q_offset, cfg_kv=cfg_kv,
                                 causal=causal, window=window,
                                 softcap=softcap, return_lse=return_lse)


def flash_prefill_contiguous(q, k, v, kv_len, q_offset, *,
                             cfg_kv: PositConfig | None = None, causal=True,
                             window=None, softcap=None, return_lse=False):
    """K7: q [B, H, Sq, D] f32 over a contiguous k/v [B, n_kv, Skv, D]
    (f32, or posit ints of cfg_kv decoded in the kernel) -> out [B, H, Sq,
    D] f32, and with return_lse also lse [B, H, Sq] f32 (0 for a row that
    sees no key).  kv_len [B] masks keys at or past it; q_offset [B] is the
    absolute position of each sequence's first query row."""
    if q.device.type == "cpu":
        return flash_prefill_contiguous_plain(
            q, k, v, kv_len, q_offset, cfg_kv=cfg_kv, causal=causal,
            window=window, softcap=softcap, return_lse=return_lse)
    lib = build.library("flash_prefill")
    dt = _kv_dtype(k, v, cfg_kv)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    q_offset = q_offset.to(torch.int32).contiguous()
    build.check_cuda_tensors("flash_prefill_contiguous", q, k, v, kv_len,
                             q_offset)
    B, H, n_kv, Sq, Skv, D = _check_prefill("flash_prefill_contiguous", q, k,
                                            v, kv_len, q_offset)
    geo = flash_geometry("fwd", D)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    n, es = (cfg_kv.n, cfg_kv.es) if cfg_kv is not None else (0, 0)
    rc = lib.flash_prefill_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        q_offset.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, H, n_kv, Sq, Skv, D,
        int(causal), _window(window), _softcap(softcap), float(D ** -0.5),
        build.DTYPE_CODE[dt], n, es, geo.threads, geo.shmem, build.stream(q))
    flash_prefill_contiguous.launches += 1
    build.check_launch(rc, "flash_prefill_fwd")
    return (out, lse) if return_lse else out


def flash_prefill_bwd_dq_plain(q, k, v, do, lse, delta, kv_len, q_offset, *,
                               cfg_kv: PositConfig | None = None, causal=True,
                               window=None, softcap=None):
    flash_prefill_bwd_dq_plain.calls += 1
    return ref.flash_prefill_bwd_parts(
        q, k, v, do, lse, delta, kv_len, q_offset, cfg_kv=cfg_kv,
        causal=causal, window=window, softcap=softcap, dkv=False)[0]


def flash_prefill_bwd_dq(q, k, v, do, lse, delta, kv_len, q_offset, *,
                         cfg_kv: PositConfig | None = None, causal=True,
                         window=None, softcap=None):
    """K8: dQ [B, H, Sq, D] from the saved lse and delta = rowsum(dO * O);
    posit KV is decoded in the kernel, as in the forward."""
    if q.device.type == "cpu":
        return flash_prefill_bwd_dq_plain(
            q, k, v, do, lse, delta, kv_len, q_offset, cfg_kv=cfg_kv,
            causal=causal, window=window, softcap=softcap)
    lib = build.library("flash_prefill")
    dt = _kv_dtype(k, v, cfg_kv)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do, lse, delta = (t.to(torch.float32).contiguous()
                      for t in (do, lse, delta))
    kv_len = kv_len.to(torch.int32).contiguous()
    q_offset = q_offset.to(torch.int32).contiguous()
    build.check_cuda_tensors("flash_prefill_bwd_dq", q, k, v, do, lse, delta,
                             kv_len, q_offset)
    B, H, n_kv, Sq, Skv, D = _check_prefill("flash_prefill_bwd_dq", q, k, v,
                                            kv_len, q_offset)
    if do.shape != q.shape or lse.shape != (B, H, Sq) or \
            delta.shape != (B, H, Sq):
        raise ValueError("flash_prefill_bwd_dq: do must match q, lse and "
                         "delta [B, H, Sq]")
    geo = flash_geometry("dq", D)
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    dq = torch.empty_like(q)
    n, es = (cfg_kv.n, cfg_kv.es) if cfg_kv is not None else (0, 0)
    rc = lib.flash_prefill_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), kv_len.data_ptr(),
        q_offset.data_ptr(), dq.data_ptr(), B, H, n_kv, Sq, Skv, D,
        int(causal), _window(window), _softcap(softcap), float(D ** -0.5),
        build.DTYPE_CODE[dt], n, es, geo.threads, geo.shmem,
        build.stream(q))
    flash_prefill_bwd_dq.launches += 1
    build.check_launch(rc, "flash_prefill_bwd_dq")
    return dq


def flash_prefill_bwd_dkv_plain(q, k, v, do, lse, delta, kv_len, q_offset, *,
                                causal=True, window=None, softcap=None):
    flash_prefill_bwd_dkv_plain.calls += 1
    _, dk, dv = ref.flash_prefill_bwd_parts(
        q, k, v, do, lse, delta, kv_len, q_offset, causal=causal,
        window=window, softcap=softcap, dq=False)
    return dk, dv


def flash_prefill_bwd_dkv(q, k, v, do, lse, delta, kv_len, q_offset, *,
                          causal=True, window=None, softcap=None):
    """K9: (dK, dV) [B, n_kv, Skv, D] for f32 k and v, summed over the G
    query heads of each kv head inside the kernel (no atomics)."""
    if q.device.type == "cpu":
        return flash_prefill_bwd_dkv_plain(
            q, k, v, do, lse, delta, kv_len, q_offset, causal=causal,
            window=window, softcap=softcap)
    lib = build.library("flash_prefill")
    _kv_dtype(k, v, None)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do, lse, delta = (t.to(torch.float32).contiguous()
                      for t in (do, lse, delta))
    kv_len = kv_len.to(torch.int32).contiguous()
    q_offset = q_offset.to(torch.int32).contiguous()
    build.check_cuda_tensors("flash_prefill_bwd_dkv", q, k, v, do, lse,
                             delta, kv_len, q_offset)
    B, H, n_kv, Sq, Skv, D = _check_prefill("flash_prefill_bwd_dkv", q, k, v,
                                            kv_len, q_offset)
    if do.shape != q.shape or lse.shape != (B, H, Sq) or \
            delta.shape != (B, H, Sq):
        raise ValueError("flash_prefill_bwd_dkv: do must match q, lse and "
                         "delta [B, H, Sq]")
    geo = flash_geometry("dkv", D)
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = lib.flash_prefill_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), kv_len.data_ptr(),
        q_offset.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, n_kv, Sq,
        Skv, D, int(causal), _window(window), _softcap(softcap),
        float(D ** -0.5), geo.threads, geo.shmem, build.stream(q))
    flash_prefill_bwd_dkv.launches += 1
    build.check_launch(rc, "flash_prefill_bwd_dkv")
    return dk, dv


def _bwd(dq_fn, dkv_fn, q, k, v, o, lse, do, kv_len, q_offset, cfg_kv,
         causal, window, softcap):
    # delta = rowsum(dO * O) outside the kernels, as the reference does
    delta = (do.float() * o.float()).sum(dim=-1)
    kw = dict(causal=causal, window=window, softcap=softcap)
    dq = dq_fn(q, k, v, do, lse, delta, kv_len, q_offset, cfg_kv=cfg_kv,
               **kw)
    if cfg_kv is not None:
        return dq, None, None           # storage ints carry no gradient
    dk, dv = dkv_fn(q, k, v, do, lse, delta, kv_len, q_offset, **kw)
    return dq, dk, dv


def flash_prefill_bwd_contiguous_plain(q, k, v, o, lse, do, kv_len,
                                       q_offset, *,
                                       cfg_kv: PositConfig | None = None,
                                       causal=True, window=None,
                                       softcap=None):
    return _bwd(flash_prefill_bwd_dq_plain, flash_prefill_bwd_dkv_plain, q,
                k, v, o, lse, do, kv_len, q_offset, cfg_kv, causal, window,
                softcap)


def flash_prefill_bwd_contiguous(q, k, v, o, lse, do, kv_len, q_offset, *,
                                 cfg_kv: PositConfig | None = None,
                                 causal=True, window=None, softcap=None):
    """Backward of flash_prefill_contiguous: (dQ, dK, dV) through K8 and
    K9 (plain versions for CPU tensors); dK = dV = None for posit KV."""
    return _bwd(flash_prefill_bwd_dq, flash_prefill_bwd_dkv, q, k, v, o, lse,
                do, kv_len, q_offset, cfg_kv, causal, window, softcap)


# ---- K14: [BH, Sq, D] attention, queries at the last Sq positions ------
def flash_attention_plain(q, k, v, *, cfg_kv: PositConfig | None = None,
                          causal=True):
    flash_attention_plain.calls += 1
    return ref.flash_attention_ref(q, k, v, cfg_kv=cfg_kv, causal=causal)


def flash_attention(q, k, v, *, cfg_kv: PositConfig | None = None,
                    causal=True):
    """K14: q [BH, Sq, D] f32 over k/v [BH, Skv, D] (f32, or posit ints of
    cfg_kv decoded in the kernel) -> [BH, Sq, D] f32; causal puts the
    queries at the last Sq positions.  K7's forward with H = n_kv = 1 per
    batch row, kv_len = Skv and q_offset = Skv - Sq; D <= 256."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, cfg_kv=cfg_kv, causal=causal)
    lib = build.library("flash_prefill")
    dt = _kv_dtype(k, v, cfg_kv)
    if q.dtype != torch.float32:
        raise TypeError(f"flash_attention: q must be float32, got {q.dtype}")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: want q [BH,Sq,D] and k, v "
                         f"[BH,Skv,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    geo = flash_geometry("fwd", D)
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    kv_len = torch.full((BH,), Skv, dtype=torch.int32, device=q.device)
    q_off = torch.full((BH,), Skv - Sq, dtype=torch.int32, device=q.device)
    build.check_cuda_tensors("flash_attention", q, k, v, kv_len, q_off)
    out = torch.empty_like(q)
    if BH == 0 or Sq == 0:
        return out
    n, es = (cfg_kv.n, cfg_kv.es) if cfg_kv is not None else (0, 0)
    rc = lib.flash_prefill_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        q_off.data_ptr(), out.data_ptr(), None, BH, 1, 1, Sq, Skv, D,
        int(causal), 0, 0.0, float(D ** -0.5), build.DTYPE_CODE[dt], n, es,
        geo.threads, geo.shmem, build.stream(q))
    flash_attention.launches += 1
    build.check_launch(rc, "flash_prefill_fwd")
    return out


for _fn in (paged_flash_decode, paged_flash_prefill,
            flash_prefill_contiguous, flash_prefill_bwd_dq,
            flash_prefill_bwd_dkv, flash_attention):
    _fn.launches = 0
for _fn in (paged_flash_decode_plain, paged_flash_prefill_plain,
            flash_prefill_contiguous_plain, flash_prefill_bwd_dq_plain,
            flash_prefill_bwd_dkv_plain, flash_attention_plain):
    _fn.calls = 0
