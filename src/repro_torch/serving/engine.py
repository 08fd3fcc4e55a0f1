"""Continuous-batching serving over pluggable per-layer caches.

The counterpart of the scheduler core of ``repro/serving/engine.py::
PagedServingEngine``: admission (batched), chunked prefill
aligned to page_size, one fused decode step over all active slots,
retirement, preemption with requeue when the pool runs dry, the
power-of-two page-table view, greedy sampling on the device and the
per-slot NaR flag.  Each layer kind has its cache backend
(serving/backends.py): attention layers the paged (posit) KV pool,
recurrent layers (rwkv6, rglru) a posit state pool of one slot per
sequence slot; hybrid patterns mix both.  A pure-recurrent model takes no
pages at all; a pattern whose attention layers are all windowed frees its
expired pages after every step (sliding-window reclamation).  Preemption
of a recurrent sequence is resume by re-prefill: its state slot is zeroed
on the first chunk and rebuilt bit for bit.

Each step moves the [max_seqs] sampled tokens and NaR flags to the host,
nothing else.  Greedy decoding only: the reference samples with threefry
keys, whose port is later work, so temperature > 0 raises.  The prefix
cache, chaos injection, TTL/deadlines, bounded queues and the mesh are not
ported; asking for one raises.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import (ModelConfig,
                                            assemble_paged_caches,
                                            extract_paged_pages, forward,
                                            init_paged_pages)
from repro_torch.serving.backends import layout_for
from repro_torch.serving.paged_kv import (GARBAGE_PAGE, PagePool,
                                          PoolExhausted, reclaimable_pages)

OUTCOMES = ("completed", "rejected", "failed_nar")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [S] int32
    max_new: int
    # tokens generated before a preemption: the resumed request re-prefills
    # prompt + prior and owes max_new - len(prior) more tokens
    prior: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32))
    submit_t: float = 0.0       # perf_counter at first submission


@dataclasses.dataclass
class RequestOutcome:
    """How one request resolved: completed, rejected (does not fit the
    pool), or failed_nar (NaR/non-finite in its logits)."""
    rid: int
    status: str
    tokens: np.ndarray
    detail: str = ""


@dataclasses.dataclass
class _Slot:
    req: Request
    admit_order: int
    pages: list                  # page ids owned, in position order
    prefill_pos: int = 0         # prompt tokens already written
    generated: list = dataclasses.field(default_factory=list)
    next_token: int = -1

    @property
    def phase(self) -> str:
        return ("prefill" if self.prefill_pos < len(self.req.prompt)
                else "decode")

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.req.max_new


class PagedServingEngine:
    """Continuous batching over one paged KV pool.

    max_seqs:      sequence slots (the fused step's batch dimension)
    page_size:     tokens per KV page
    table_width:   max pages per sequence (caps sequence length)
    num_pages:     pool size; default fits max_seqs full-length sequences
                   plus the garbage page (2 pages for a model with no
                   attention layer, whose pool nothing reads)
    prefill_chunk: prompt tokens per prefill step, aligned down to a
                   page_size multiple (floor one page)
    device:        "cuda" (default) or "cpu"

    Admissions batch as the reference's default does: freed slots wait
    until max_seqs // 2 are free, unless nothing decodes or a prefill
    phase already runs.
    """

    def __init__(self, params, cfg: ModelConfig, *, max_seqs: int = 8,
                 page_size: int = 64, table_width: int = 16,
                 num_pages: int | None = None, prefill_chunk: int = 128,
                 temperature: float = 0.0, prefix_cache: bool = False,
                 mesh=None, tp_compress=None, max_waiting: int | None = None,
                 default_ttl_steps: int | None = None,
                 default_deadline_s: float | None = None, chaos=None,
                 device="cuda"):
        unported = {"prefix_cache": prefix_cache, "mesh": mesh,
                    "tp_compress": tp_compress, "max_waiting": max_waiting,
                    "default_ttl_steps": default_ttl_steps,
                    "default_deadline_s": default_deadline_s,
                    "chaos": chaos}
        asked = [k for k, v in unported.items() if v not in (None, False)]
        if asked:
            raise NotImplementedError(f"not ported yet: {asked}")
        if temperature > 0.0:
            raise NotImplementedError("temperature sampling is not ported "
                                      "(the reference's threefry keys); "
                                      "serve greedy with temperature=0")
        self.device = resolve_device(device)
        self.params, self.cfg = params, cfg
        self.max_seqs, self.page = max_seqs, page_size
        self.width = table_width
        self.chunk = max(page_size, (prefill_chunk // page_size) * page_size)
        self.admit_threshold = max_seqs // 2
        self.layout = layout_for(cfg)
        if num_pages is None:
            num_pages = (max_seqs * table_width + 1
                         if self.layout.needs_pages else 2)
        self.num_pages = num_pages
        self.pages = init_paged_pages(cfg, num_pages, page_size,
                                      max_seqs=max_seqs, device=self.device)
        # eager sliding-window reclamation: sound only when every attention
        # layer is windowed (a full-attention layer still reads old pages)
        attn = [k for k in cfg.block_pattern if k in ("attn", "attn_local")]
        self._reclaim_window = (
            cfg.window if attn and cfg.window
            and all(k == "attn_local" for k in attn) else None)
        self._pool = PagePool(num_pages)
        self.table = np.zeros((max_seqs, table_width), np.int32)
        self.seq_lens = np.zeros((max_seqs,), np.int32)
        self.slots: list[_Slot | None] = [None] * max_seqs
        self.waiting: deque[Request] = deque()
        self._admitted = 0
        self._next_rid = 0
        self.finished: dict[int, np.ndarray] = {}
        self.outcomes: dict[int, RequestOutcome] = {}
        self.counters = collections.Counter()
        # wall seconds of each step by kind, and each request's time to its
        # first token (from submission)
        self.step_times: dict[str, list[float]] = {"prefill": [],
                                                   "decode": []}
        self.ttft_s: dict[int, float] = {}

    # ---- host-side paging ------------------------------------------------
    def _alloc_page(self, i: int) -> int:
        """A free page for slot i, preempting the youngest other sequence
        when the pool is dry; PoolExhausted when nothing is left."""
        while True:
            pg = self._pool.try_alloc()
            if pg is not None:
                return pg
            if not self._preempt(exclude=i):
                raise PoolExhausted(
                    "KV pool exhausted and nothing left to preempt; grow "
                    "num_pages or lower max_seqs")

    def _ensure_pages(self, i: int, upto: int):
        if not self.layout.needs_pages:
            return                     # state pools only: no KV pages
        slot = self.slots[i]
        need = -(-upto // self.page)
        if need > self.width:
            raise ValueError(f"request {slot.req.rid}: {upto} tokens exceed "
                             f"table_width*page_size = "
                             f"{self.width * self.page}")
        while len(slot.pages) < need:
            pg = self._alloc_page(i)
            self.table[i, len(slot.pages)] = pg
            slot.pages.append(pg)

    def _free_slot(self, i: int):
        for pg in self.slots[i].pages:
            if pg:                     # 0: a reclaimed window page
                self._pool.decref(pg)
        self.table[i, :] = 0
        self.seq_lens[i] = 0
        self.slots[i] = None

    def _preempt(self, exclude: int) -> bool:
        """Evict the youngest other sequence: free its pages and requeue it
        (prompt + generated so far) at the front of the wait queue."""
        victims = [(s.admit_order, i) for i, s in enumerate(self.slots)
                   if s is not None and i != exclude]
        if not victims:
            return False
        _, i = max(victims)
        slot = self.slots[i]
        req = slot.req
        gen = np.asarray(slot.generated, np.int32)
        self.waiting.appendleft(Request(
            req.rid, np.concatenate([req.prompt, gen]),
            req.max_new - len(slot.generated),
            prior=np.concatenate([req.prior, gen]), submit_t=req.submit_t))
        self._free_slot(i)
        self.counters["preempted"] += 1
        return True

    # ---- outcomes ---------------------------------------------------------
    def _resolve(self, req: Request, status: str, detail: str = "",
                 generated=None):
        gen = np.asarray([] if generated is None else generated, np.int32)
        toks = np.concatenate([req.prior, gen]) if len(req.prior) else gen
        self.outcomes[req.rid] = RequestOutcome(req.rid, status, toks, detail)
        self.counters[status] += 1
        if status == "completed":
            self.finished[req.rid] = toks
            self.counters["finished"] += 1

    def _fail_slot(self, i: int, status: str, detail: str):
        slot = self.slots[i]
        if status == "failed_nar":
            self._scrub_slot_pages(i)
        self._resolve(slot.req, status, detail=detail,
                      generated=slot.generated)
        self._free_slot(i)

    def _scrub_slot_pages(self, i: int):
        """Overwrite a NaR'd sequence's pages with the garbage page's finite
        bits before they return to the pool: a recycled page's stale NaN
        would poison the plain attention's masked products (0 * NaN)."""
        for pg in self.slots[i].pages:
            if pg and self._pool.ref_count(pg) == 1:
                for layer in self.pages["layers"]:
                    if "k_pages" not in layer:
                        continue       # a state pool
                    for key in ("k_pages", "v_pages"):
                        buf = layer[key]
                        buf = getattr(buf, "bits", buf)
                        buf[pg] = buf[GARBAGE_PAGE]
                self.counters["scrubbed_pages"] += 1

    # ---- admission -------------------------------------------------------
    def _admit(self):
        if not self.waiting:
            return
        phases = [s.phase for s in self.slots if s is not None]
        n_free = self.max_seqs - len(phases)
        if ("decode" in phases and "prefill" not in phases
                and n_free < max(1, self.admit_threshold)):
            return
        while self.waiting:
            req = self.waiting[0]
            need = -(-(len(req.prompt) + 1) // self.page)
            free = [i for i in range(self.max_seqs) if self.slots[i] is None]
            if not free or (self.layout.needs_pages
                            and need > self._pool.n_free):
                if self.active == 0:
                    self.waiting.popleft()
                    self._resolve(req, "rejected",
                                  detail=f"does not fit the idle pool "
                                         f"({self._pool.n_free} free pages)")
                    continue
                return
            i = free[0]
            self.waiting.popleft()
            self.slots[i] = _Slot(req=req, admit_order=self._admitted,
                                  pages=[])
            self._admitted += 1
            self.counters["admitted"] += 1

    # ---- public API ------------------------------------------------------
    def submit(self, prompt, max_new: int, rid: int | None = None) -> int:
        """Queue a request.  Malformed input raises ValueError; a request
        that can never fit the page table resolves `rejected`."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("prompt must contain at least one token")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if rid is None:
            rid = self._next_rid
        elif (rid in self.outcomes or any(r.rid == rid for r in self.waiting)
              or any(s is not None and s.req.rid == rid for s in self.slots)):
            raise ValueError(f"request id {rid} is already in use")
        self._next_rid = max(self._next_rid, rid + 1)
        self.counters["submitted"] += 1
        req = Request(rid, prompt, max_new, submit_t=time.perf_counter())
        # the page table bounds only layouts with KV layers: a state slot
        # is O(1) in the sequence's length
        if (self.layout.needs_pages
                and len(prompt) + max_new > self.width * self.page):
            self._resolve(req, "rejected",
                          detail=f"prompt+max_new = {len(prompt) + max_new} "
                                 f"exceeds per-sequence capacity "
                                 f"{self.width * self.page}")
            return rid
        self.waiting.append(req)
        return rid

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def stats(self) -> dict:
        d = {k: 0 for k in ("admitted", "finished", "preempted",
                            "prefill_steps", "decode_steps", "submitted",
                            "scrubbed_pages", "expired_page_frees",
                            *OUTCOMES)}
        d.update(self.counters)
        d["free_pages"] = self._pool.n_free
        for kind, ts in self.step_times.items():
            d[f"{kind}_step_p50_ms"] = (float(np.percentile(ts, 50)) * 1e3
                                        if ts else 0.0)
        return d

    def _table_view(self, participants) -> np.ndarray:
        """Power-of-two page-table slice sized to the participating slots
        (a slot outside them has num_new 0: its writes drop and its
        outputs are ignored, so truncating its pages is safe)."""
        used = max([len(self.slots[i].pages) for i in participants
                    if self.slots[i] is not None], default=1)
        w = 1
        while w < max(used, 1):
            w *= 2
        return self.table[:, :min(w, self.width)]

    def _run_step(self, tokens: np.ndarray, num_new: np.ndarray,
                  participants, kind: str):
        """One fused forward over all slots; returns the greedy token and
        the NaR flag per slot ([max_seqs] int32 / bool)."""
        t0 = time.perf_counter()
        dev = self.device
        pt = torch.from_numpy(np.ascontiguousarray(
            self._table_view(participants))).to(dev)
        sl = torch.from_numpy(self.seq_lens.copy()).to(dev)
        nn = torch.from_numpy(num_new).to(dev)
        tok = torch.from_numpy(tokens).to(dev)
        with torch.inference_mode():
            caches = assemble_paged_caches(self.pages, pt, sl, nn)
            logits, _, new_caches = forward(self.params, self.cfg,
                                            tokens=tok, caches=caches)
            # last *valid* position per slot (ragged prefill chunks)
            idx = (nn.long() - 1).clamp(0, tokens.shape[1] - 1)
            last = logits[torch.arange(logits.shape[0], device=dev), idx]
            nar = ~torch.isfinite(last).all(dim=-1)
            toks = last.argmax(dim=-1).to(torch.int32)
            self.pages = extract_paged_pages(new_caches)
            toks, nar = toks.cpu().numpy(), nar.cpu().numpy()
        self.seq_lens += num_new
        self._reclaim_expired()
        self.step_times[kind].append(time.perf_counter() - t0)
        return toks, nar

    def _reclaim_expired(self):
        """Free the KV pages every token of which has slid out of the
        attention window (patterns whose attention layers are all
        windowed).  Freed table entries point at the garbage page, which
        the window masks of both attention kernels exclude, so a recycled
        page may hold another sequence's KV without being read; slot.pages
        keeps a 0 placeholder so later positions stay aligned."""
        if self._reclaim_window is None:
            return
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            n = reclaimable_pages(int(self.seq_lens[i]),
                                  self._reclaim_window, self.page)
            for j in range(min(n, len(slot.pages))):
                pg = slot.pages[j]
                if pg:
                    self._pool.decref(pg)
                    slot.pages[j] = 0
                    self.table[i, j] = GARBAGE_PAGE
                    self.counters["expired_page_frees"] += 1

    def _page_in(self, i: int) -> bool:
        """Allocate slot i's pages for its next write; a request that alone
        exceeds the pool resolves `rejected`.  False if the slot died."""
        slot = self.slots[i]
        n = (min(self.chunk, len(slot.req.prompt) - slot.prefill_pos)
             if slot.phase == "prefill" else 1)
        try:
            self._ensure_pages(i, int(self.seq_lens[i]) + n)
            return True
        except PoolExhausted as e:
            self._fail_slot(i, "rejected", detail=str(e))
            return False

    def _emit(self, i: int, tok: int, emitted: list):
        s = self.slots[i]
        if not s.generated and not len(s.req.prior):
            self.ttft_s[s.req.rid] = time.perf_counter() - s.req.submit_t
        s.generated.append(tok)
        s.next_token = tok
        emitted.append((s.req.rid, tok))

    def step(self) -> list[tuple[int, int]]:
        """One scheduler iteration; returns the (rid, token) pairs emitted."""
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.done:
                self._resolve(slot.req, "completed",
                              generated=slot.generated)
                self._free_slot(i)
        self._admit()

        emitted: list[tuple[int, int]] = []
        prefilling = [i for i, s in enumerate(self.slots)
                      if s is not None and s.phase == "prefill"]
        if prefilling:
            # page in first: allocation may preempt a slot (even one in
            # `prefilling`), so the batch is built only from survivors
            for i in prefilling:
                if self.slots[i] is not None:
                    self._page_in(i)
            alive = [i for i in prefilling if self.slots[i] is not None]
            if not alive:
                return emitted
            tokens = np.zeros((self.max_seqs, self.chunk), np.int32)
            num_new = np.zeros((self.max_seqs,), np.int32)
            for i in alive:
                s = self.slots[i]
                part = s.req.prompt[s.prefill_pos:s.prefill_pos + self.chunk]
                tokens[i, :len(part)] = part
                num_new[i] = len(part)
            toks, bad = self._run_step(tokens, num_new, alive, "prefill")
            for i in alive:
                s = self.slots[i]
                s.prefill_pos += int(num_new[i])
                if bad[i]:
                    self._fail_slot(i, "failed_nar",
                                    "NaR detected in output logits")
                    continue
                if s.phase == "decode":
                    self._emit(i, int(toks[i]), emitted)
            self.counters["prefill_steps"] += 1
            return emitted

        decoding = [i for i, s in enumerate(self.slots)
                    if s is not None and s.phase == "decode" and not s.done]
        for i in decoding:
            if self.slots[i] is not None:
                self._page_in(i)
        decoding = [i for i in decoding if self.slots[i] is not None]
        if not decoding:
            return emitted
        tokens = np.zeros((self.max_seqs, 1), np.int32)
        num_new = np.zeros((self.max_seqs,), np.int32)
        for i in decoding:
            tokens[i, 0] = self.slots[i].next_token
            num_new[i] = 1
        toks, bad = self._run_step(tokens, num_new, decoding, "decode")
        for i in decoding:
            if bad[i]:
                self._fail_slot(i, "failed_nar",
                                "NaR detected in output logits")
                continue
            self._emit(i, int(toks[i]), emitted)
        self.counters["decode_steps"] += 1
        return emitted

    def run(self, requests=None, max_steps: int | None = None
            ) -> dict[int, np.ndarray]:
        """Drain: submit `requests` (iterable of (prompt, max_new)) and step
        until everything resolved.  Returns {rid: generated tokens}."""
        if requests is not None:
            for prompt, max_new in requests:
                self.submit(prompt, max_new)
        steps = 0
        while self.waiting or self.active:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return dict(self.finished)
