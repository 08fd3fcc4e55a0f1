"""K3/K4: paged decode and paged prefill attention
(``csrc/paged_attention.cu``).

`paged_flash_decode` replaces ``repro/kernels/flash_attention.py::
paged_flash_decode`` (:650) and `paged_flash_prefill` replaces
``::paged_flash_prefill`` (:259).  Only the paged entry points are ported;
the contiguous prefill, its backward and the rectangular flash attention
are later work.  Rows that see no key (l == 0) come back 0 from the
kernels; the plain versions keep the reference's -1e30 masking there.
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


for _fn in (paged_flash_decode, paged_flash_prefill):
    _fn.launches = 0
for _fn in (paged_flash_decode_plain, paged_flash_prefill_plain):
    _fn.calls = 0
