"""K3/K4: paged decode and paged prefill attention
(``csrc/paged_attention.cu``); K7-K9: the contiguous flash prefill with its
log-sum-exp and its backward (``csrc/flash_prefill.cu``).

`paged_flash_decode` replaces ``repro/kernels/flash_attention.py::
paged_flash_decode`` (:650), `paged_flash_prefill` replaces
``::paged_flash_prefill`` (:259), `flash_prefill_contiguous` replaces
``::flash_prefill_contiguous`` (:332) and `flash_prefill_bwd_contiguous`
``::flash_prefill_bwd_contiguous`` (:552), whose two passes are the
separately counted `flash_prefill_bwd_dq` and `flash_prefill_bwd_dkv`.
The rectangular `flash_attention` is later work.  Rows that see no key
(l == 0) come back 0 from the kernels; the paged plain versions keep the
reference's -1e30 masking there, the contiguous ones give 0 as well.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import PositConfig
from repro_torch.kernels import build, ref

_MAX_SHARED = 48 * 1024       # static-launch limit without opt-in


def _pool_dtype(k_pages, v_pages, cfg_kv):
    dt = (torch.float32 if cfg_kv is None
          else getattr(torch, cfg_kv.storage_dtype_name))
    if k_pages.dtype != dt or v_pages.dtype != dt:
        raise TypeError(f"pages must be {dt} for cfg_kv={cfg_kv}, got "
                        f"{k_pages.dtype}/{v_pages.dtype}")
    return dt


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
    q = q.to(torch.float32).contiguous()
    page_table = page_table.to(torch.int32).contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    build.check_cuda_tensors("paged_flash_decode", q, k_pages, v_pages,
                             page_table, seq_lens)
    B, H, D = q.shape
    P, n_kv, page, _ = k_pages.shape
    G = H // n_kv
    if H % n_kv or D != k_pages.shape[3]:
        raise ValueError("paged_flash_decode: head layout does not match "
                         "the pool")
    # positions per round: whole pages, ~4096 K elements of shared memory
    ch = page * max(1, (4096 // D) // page)
    shmem = 4 * (2 * G * D + ch * (2 * D + 1) + G * ch + 3 * G + ch)
    if shmem > _MAX_SHARED:
        raise ValueError(f"paged_flash_decode: {shmem} B of shared memory "
                         f"exceeds {_MAX_SHARED}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    n, es = (cfg_kv.n, cfg_kv.es) if cfg_kv is not None else (0, 0)
    rc = lib.posit_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), B, H,
        n_kv, page, D, page_table.shape[1], P,
        0 if window is None else int(window), ch, float(D ** -0.5),
        build.DTYPE_CODE[dt], n, es, build.stream(q))
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
    lib = build.library("paged_attention")
    dt = _pool_dtype(k_pages, v_pages, cfg_kv)
    q = q.to(torch.float32).contiguous()
    page_table = page_table.to(torch.int32).contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    q_offset = q_offset.to(torch.int32).contiguous()
    build.check_cuda_tensors("paged_flash_prefill", q, k_pages, v_pages,
                             page_table, seq_lens, q_offset)
    B, H, Sq, D = q.shape
    P, n_kv, page, _ = k_pages.shape
    G = H // n_kv
    if H % n_kv or D != k_pages.shape[3] or D > 128 or G > 32:
        raise ValueError("paged_flash_prefill: needs H % n_kv == 0, "
                         "D <= 128 and at most 32 query heads per kv head")
    shmem = 4 * (2 * page * D + page * G * 32)
    if shmem > _MAX_SHARED:
        raise ValueError(f"paged_flash_prefill: {shmem} B of shared memory "
                         f"exceeds {_MAX_SHARED}")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    n, es = (cfg_kv.n, cfg_kv.es) if cfg_kv is not None else (0, 0)
    rc = lib.posit_paged_prefill(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), q_offset.data_ptr(),
        out.data_ptr(), B, H, n_kv, Sq, page, D, page_table.shape[1], P,
        int(causal), 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), float(D ** -0.5),
        build.DTYPE_CODE[dt], n, es, build.stream(q))
    paged_flash_prefill.launches += 1
    build.check_launch(rc, "posit_paged_prefill")
    return out


# ---- K7-K9: the contiguous prefill and its backward ---------------------
_BQ = 32                      # query rows per head per block (K7, K8)


def _kv_dtype(k, v, cfg_kv):
    dt = (torch.float32 if cfg_kv is None
          else getattr(torch, cfg_kv.storage_dtype_name))
    if k.dtype != dt or v.dtype != dt:
        raise TypeError(f"k/v must be {dt} for cfg_kv={cfg_kv}, got "
                        f"{k.dtype}/{v.dtype}")
    return dt


def _check_prefill(fn, q, k, v, kv_len, q_offset):
    """Shapes the K7-K9 kernels take -> (B, H, n_kv, Sq, Skv, D)."""
    if q.dtype != torch.float32:
        raise TypeError(f"{fn}: q must be float32, got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{fn}: q [B,H,Sq,D] and k, v [B,n_kv,Skv,D] "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    _, n_kv, Skv, _ = k.shape
    if (k.shape[0] != B or k.shape[3] != D or H % n_kv or D % 4 or D > 128
            or (H // n_kv) * _BQ > 1024):
        raise ValueError(f"{fn}: needs matching B and D, H % n_kv == 0, "
                         f"D % 4 == 0, D <= 128 and at most 32 query heads "
                         f"per kv head")
    if kv_len.shape != (B,) or q_offset.shape != (B,):
        raise ValueError(f"{fn}: kv_len and q_offset must be [B] = [{B}]")
    return B, H, n_kv, Sq, Skv, D


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
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    n, es = (cfg_kv.n, cfg_kv.es) if cfg_kv is not None else (0, 0)
    rc = lib.flash_prefill_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        q_offset.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, H, n_kv, Sq, Skv, D,
        int(causal), _window(window), _softcap(softcap), float(D ** -0.5),
        build.DTYPE_CODE[dt], n, es, build.stream(q))
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
    dq = torch.empty_like(q)
    n, es = (cfg_kv.n, cfg_kv.es) if cfg_kv is not None else (0, 0)
    rc = lib.flash_prefill_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), kv_len.data_ptr(),
        q_offset.data_ptr(), dq.data_ptr(), B, H, n_kv, Sq, Skv, D,
        int(causal), _window(window), _softcap(softcap), float(D ** -0.5),
        build.DTYPE_CODE[dt], n, es, build.stream(q))
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
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = lib.flash_prefill_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), kv_len.data_ptr(),
        q_offset.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, n_kv, Sq,
        Skv, D, int(causal), _window(window), _softcap(softcap),
        float(D ** -0.5), build.stream(q))
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


for _fn in (paged_flash_decode, paged_flash_prefill,
            flash_prefill_contiguous, flash_prefill_bwd_dq,
            flash_prefill_bwd_dkv):
    _fn.launches = 0
for _fn in (paged_flash_decode_plain, paged_flash_prefill_plain,
            flash_prefill_contiguous_plain, flash_prefill_bwd_dq_plain,
            flash_prefill_bwd_dkv_plain):
    _fn.calls = 0
