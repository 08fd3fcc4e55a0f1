"""Block-paged (posit) KV cache, the serving-side memory system.

The counterpart of ``repro/serving/paged_kv.py``: one page pool per
attention layer, ``k_pages``/``v_pages`` [num_pages, n_kv, page_size,
head_dim] (`PositArray` pages under a posit KV policy, f32 otherwise), a
per-sequence ``page_table`` [max_seqs, W] and ``seq_lens`` [max_seqs].
Page 0 is the garbage page: unallocated table entries point at it and it
is never handed out.  Masked writes are dropped, never written anywhere.

The reference's arrays are immutable and its step donates the pools; here
the append writes the pools in place, which is what donation achieves.

Layer cache dict: {"k_pages", "v_pages", "page_table", "seq_lens",
"num_new"}.
"""
from __future__ import annotations

import torch

from repro_torch.core.array import PositArray
from repro_torch.core.types import PositConfig
from repro_torch.kernels import ops, ref

GARBAGE_PAGE = 0


class PoolExhausted(RuntimeError):
    """A page allocation found nothing free and nothing preemptible."""


def reclaimable_pages(seq_len: int, window: int, page_size: int) -> int:
    """How many leading pages of a sequence have slid entirely out of a
    `window`-token attention window at length `seq_len` (post-append).

    The newest query sits at seq_len - 1 and sees kpos in (seq_len - 1 -
    window, seq_len); page j (tokens [j*page, (j+1)*page)) has expired when
    (j+1)*page <= seq_len - window.  seq_len only grows, so expiry is
    monotone and the engine frees expired pages eagerly; the attention
    kernels' window masks hide whatever a freed page's id is recycled
    into."""
    return max(0, (seq_len - window) // page_size)


class PagePool:
    """Host-side allocator of one page pool, with refcounts.

    Page 0 (the garbage page) is never allocated or freed.  Invariants:
    refcounts never go negative, a page is never freed twice, and
    free + live == num_pages - 1.  (The reference's prefix-cache pinning is
    a later port.)
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least the garbage page + one page")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))   # pop() -> page 1
        self._ref: dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def ref_count(self, page: int) -> int:
        return self._ref.get(page, 0)

    def try_alloc(self) -> int | None:
        """Pop a free page with refcount 1, or None when none is free."""
        if not self._free:
            return None
        page = self._free.pop()
        if page in self._ref:
            raise AssertionError(f"page {page} on the free stack while live")
        self._ref[page] = 1
        return page

    def decref(self, page: int):
        """One fewer reference; at 0 the page returns to the free stack."""
        if not 0 < page < self.num_pages:
            raise ValueError(f"page {page} out of range (garbage page 0 "
                             f"never participates)")
        if self._ref.get(page, 0) <= 0:
            raise ValueError(f"decref of page {page} with no references "
                             f"(double free?)")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            del self._ref[page]
            self._free.append(page)


def init_layer_pages(num_pages: int, n_kv: int, page_size: int,
                     head_dim: int, cfg: PositConfig | None,
                     device) -> dict:
    """One attention layer's page pools: {"k_pages", "v_pages"}."""
    shape = (num_pages, n_kv, page_size, head_dim)
    if cfg is not None:
        dt = getattr(torch, cfg.storage_dtype_name)
        return {"k_pages": PositArray(torch.zeros(shape, dtype=dt,
                                                  device=device), cfg),
                "v_pages": PositArray(torch.zeros(shape, dtype=dt,
                                                  device=device), cfg)}
    return {"k_pages": torch.zeros(shape, dtype=torch.float32, device=device),
            "v_pages": torch.zeros(shape, dtype=torch.float32, device=device)}


def assemble_layer_cache(pages: dict, page_table, seq_lens, num_new) -> dict:
    return {"k_pages": pages["k_pages"], "v_pages": pages["v_pages"],
            "page_table": page_table, "seq_lens": seq_lens,
            "num_new": num_new}


def extract_layer_pages(cache: dict) -> dict:
    return {"k_pages": cache["k_pages"], "v_pages": cache["v_pages"]}


def is_paged(cache) -> bool:
    return isinstance(cache, dict) and "page_table" in cache


def paged_append_kv(cache: dict, k, v) -> dict:
    """Write `num_new` new tokens per sequence into the pools (in place).

    k, v [B, n_kv, S, D] float.  Token j of sequence i lands at position
    seq_lens[i] + j -> (page_table[i, pos // page], pos % page); tokens with
    j >= num_new[i] are dropped.  Returns the cache with seq_lens advanced.
    """
    ops.paged_append(k, v, cache["k_pages"], cache["v_pages"],
                     cache["page_table"], cache["seq_lens"], cache["num_new"])
    return {**cache, "seq_lens": cache["seq_lens"] + cache["num_new"]}


def gather_kv(cache: dict):
    """Dense view of the paged cache: [B, n_kv, W * page, D], position-
    identical to a dense cache of max_len W * page (PositArray stays
    posit)."""
    kp, vp = cache["k_pages"], cache["v_pages"]
    table = cache["page_table"]
    if isinstance(kp, PositArray):
        return (PositArray(ref.gather_pages(kp.bits, table), kp.cfg),
                PositArray(ref.gather_pages(vp.bits, table), vp.cfg))
    return ref.gather_pages(kp, table), ref.gather_pages(vp, table)


def paged_attention(q, cache: dict, *, n_kv: int, causal: bool = True,
                    q_offset=None, window=None, softcap=None):
    """Attention of q [B, H, Sq, D] over a post-append paged cache.

    Routed as the reference routes its kernels: Sq == 1 without softcap
    takes the paged decode, everything else the paged prefill.
    q_offset [B] (default seq_lens - num_new) is each sequence's first
    query position.
    """
    B, H, Sq, D = q.shape
    if H % n_kv:
        raise ValueError(f"{H} query heads do not group over {n_kv} kv heads")
    if q_offset is None:
        q_offset = cache["seq_lens"] - cache["num_new"]
    if Sq == 1 and softcap is None:
        out = ops.paged_decode_attention(
            q[:, :, 0, :], cache["k_pages"], cache["v_pages"],
            cache["page_table"], cache["seq_lens"], window=window)
        return out[:, :, None, :].to(q.dtype)
    q_off = torch.as_tensor(q_offset, device=q.device).reshape(-1)
    q_off = q_off.expand(B).to(torch.int32)
    out = ops.paged_prefill_attention(
        q, cache["k_pages"], cache["v_pages"], cache["page_table"],
        cache["seq_lens"], q_off, causal=causal, window=window,
        softcap=softcap)
    return out.to(q.dtype)
