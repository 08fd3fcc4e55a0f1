"""Per-layer sequence-cache backends of the serving engine.

The counterpart of ``repro/serving/backends.py``:

  * `PagedKVBackend`: the block-paged (posit) KV pool of attn/attn_local
    layers (serving/paged_kv.py);
  * `StatePoolBackend`: one fixed-size (posit) state slot per serving slot
    for the recurrent kinds: rwkv6 keeps the WKV state matrix and the
    time- and channel-mix token shifts, rglru the hidden vector and the
    causal-conv tail.  O(1) bytes per sequence, no pages;
  * `HybridLayout`: the per-pattern composition (recurrentgemma mixes
    windowed KV pages and state slots; all-attention and all-recurrent
    stacks are the plain cases).

State leaves are `PositArray`s under a posit KV policy (`cfg.policy.
kv_cache`) and f32 otherwise.  An assembled state cache carries the step's
`seq_lens`/`num_new` like an assembled KV cache
(models/transformer.py::assemble_paged_caches).  A slot's state belongs to
whichever request holds the serving slot: `zero_fresh` resets it on the
request's first prefill chunk (seq_lens == 0), so preemption is resume by
re-prefill, which regenerates the state bit for bit (every value that
crosses a token boundary is posit-round-tripped, so the scans do not
depend on where chunks split).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.array import PositArray
from repro_torch.kernels import ops

CONV_WIDTH = 4          # models/griffin.py's causal-conv width


def state_f32(s) -> torch.Tensor:
    """Decoded f32 view of a carried state leaf (PositArray or float)."""
    if isinstance(s, PositArray):
        return ops.decode(s)
    return s.to(torch.float32)


def zero_fresh(buf, seq_lens):
    """Zero the slots that start a sequence this step (seq_lens == 0).
    Posit zero is the all-zero pattern, so zeroing bits encodes 0.0; other
    slots keep their state untouched."""
    raw = buf.bits if isinstance(buf, PositArray) else buf
    live = (seq_lens > 0).reshape((-1,) + (1,) * (raw.ndim - 1))
    out = torch.where(live, raw, torch.zeros((), dtype=raw.dtype,
                                             device=raw.device))
    return PositArray(out, buf.cfg) if isinstance(buf, PositArray) else out


def store_state(old, new_f32, num_new):
    """`new_f32` in the pool representation of `old`, only for slots that
    advanced this step (num_new > 0): idle slots keep their bits exactly."""
    raw = old.bits if isinstance(old, PositArray) else old
    live = (None if num_new is None
            else (num_new > 0).reshape((-1,) + (1,) * (raw.ndim - 1)))
    if isinstance(old, PositArray):
        bits = ops.encode(new_f32.to(torch.float32), old.cfg)
        if live is not None:
            bits = torch.where(live, bits, old.bits)
        return PositArray(bits, old.cfg)
    new = new_f32.to(old.dtype)
    return new if live is None else torch.where(live, new, old)


def _state_zeros(shape, pcfg, device):
    if pcfg is not None:
        dt = getattr(torch, pcfg.storage_dtype_name)
        return PositArray(torch.zeros(shape, dtype=dt, device=device), pcfg)
    return torch.zeros(shape, dtype=torch.float32, device=device)


@dataclass(frozen=True)
class LayerCacheDesc:
    """What one layer costs per sequence."""
    kind: str                  # attn / attn_local / rwkv6 / rglru
    backend: str               # "paged_kv" | "state_pool"
    bytes_per_token: int       # KV bytes per cached token (0 for state)
    state_bytes_per_seq: int   # fixed per-sequence state bytes (0 for KV)
    window: int | None         # attn_local sliding window, if any

    def bytes_per_seq(self, context: int, page_size: int) -> int:
        """Cache bytes one sequence holds at `context` tokens; windowed KV
        counts only live pages (reclamation frees expired ones): a window
        of W tokens spans at most ceil(W / page) + 1 pages."""
        if self.backend == "state_pool":
            return self.state_bytes_per_seq
        live = context
        if self.window is not None:
            live = min(context, self.window + page_size)
        n_pages = -(-live // page_size) if live else 0
        return n_pages * page_size * self.bytes_per_token


def _elem_bytes(cfg) -> int:
    pcfg = cfg.policy.kv_cache
    return pcfg.storage_bits // 8 if pcfg is not None else 4


class PagedKVBackend:
    """The block-paged KV pool behind the backend protocol."""
    backend = "paged_kv"
    needs_pages = True

    def __init__(self, kind: str):
        self.kind = kind

    def init_layer(self, cfg, num_pages, page_size, max_seqs, device):
        from repro_torch.serving.paged_kv import init_layer_pages
        return init_layer_pages(num_pages, cfg.n_kv, page_size, cfg.hd,
                                cfg.policy.kv_cache, device)

    def desc(self, cfg, page_size) -> LayerCacheDesc:
        return LayerCacheDesc(
            kind=self.kind, backend=self.backend,
            bytes_per_token=2 * cfg.n_kv * cfg.hd * _elem_bytes(cfg),
            state_bytes_per_seq=0,
            window=cfg.window if self.kind == "attn_local" else None)


class StatePoolBackend:
    """Fixed-size per-slot recurrent state, posit when the KV policy is
    set; the engine's slot index is the state index."""
    backend = "state_pool"
    needs_pages = False

    def __init__(self, kind: str):
        if kind not in ("rwkv6", "rglru"):
            raise ValueError(f"no state-pool layout for block kind {kind!r}")
        self.kind = kind

    def _shapes(self, cfg, max_seqs):
        d = cfg.d_model
        if self.kind == "rwkv6":
            dh = cfg.rwkv_head_dim
            return {"wkv": (max_seqs, d // dh, dh, dh),
                    "tshift": (max_seqs, d), "cshift": (max_seqs, d)}
        return {"h": (max_seqs, d), "conv": (max_seqs, CONV_WIDTH - 1, d)}

    def init_layer(self, cfg, num_pages, page_size, max_seqs, device):
        if max_seqs < 1:
            raise ValueError(
                f"state-pool layer ({self.kind}) needs max_seqs >= 1")
        pcfg = cfg.policy.kv_cache
        return {k: _state_zeros(shape, pcfg, device)
                for k, shape in self._shapes(cfg, max_seqs).items()}

    def desc(self, cfg, page_size) -> LayerCacheDesc:
        elems = sum(math.prod(shape[1:])
                    for shape in self._shapes(cfg, 1).values())
        return LayerCacheDesc(kind=self.kind, backend=self.backend,
                              bytes_per_token=0,
                              state_bytes_per_seq=elems * _elem_bytes(cfg),
                              window=None)


def backend_for(kind: str, cfg) -> PagedKVBackend | StatePoolBackend:
    if kind in ("attn", "attn_local"):
        return PagedKVBackend(kind)
    return StatePoolBackend(kind)


class HybridLayout:
    """Per-pattern-position backends of one model config."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.backends = tuple(backend_for(k, cfg) for k in cfg.block_pattern)

    @property
    def needs_pages(self) -> bool:
        return any(b.needs_pages for b in self.backends)

    def descs(self, page_size) -> list[LayerCacheDesc]:
        """One descriptor per layer (layer i is block_pattern[i % P])."""
        P = len(self.backends)
        return [self.backends[i % P].desc(self.cfg, page_size)
                for i in range(self.cfg.n_layers)]

    def cache_bytes_per_seq(self, context: int, page_size: int) -> int:
        return sum(d.bytes_per_seq(context, page_size)
                   for d in self.descs(page_size))


def layout_for(cfg) -> HybridLayout:
    return HybridLayout(cfg)
