#!/usr/bin/env python3
"""Bring-up check of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--out FILE]

Phases, in order; any failure exits non-zero and prints no result:

1. the card's name and power limit, then the build of every CUDA kernel
   from ``src/repro_torch/csrc`` (one nvcc per source, all in parallel);
2. every kernel against its plain PyTorch version on the card, at the
   shapes of full-width smollm-360m, for posit16, posit8 and float pages:
   the codec bit-exact (exhaustive decode, encode over an f32 sweep), the
   posit GEMM within the f32 dot-product error bound, the paged attention
   within 1e-4; each kernel also timed beside its plain version, one
   PyTorch library call where one exists, and the card's bound;
3. the main path: full-width smollm-360m from the port's seeded init,
   post-training quantized to posit16 (weights and KV), serving 16
   requests through PagedServingEngine with every launch counter zeroed
   just before and read just after; then the kernel path's logits against
   the plain path's on the CPU, and a smoke-size drain on the card against
   the same drain on the CPU, token for token; between them, 8 decode
   steps under torch.profiler (outside the counted run) for the device's
   busy share;
4. ``kernels: {...}`` with each kernel's launches on the main path, the
   card's name and power limit, one JSON line of per-kernel numbers, and
   last the contract line ``{"ok": true, "device": {...}}``.

Float32 matmuls run in full f32 here and in the port (TF32 off).
``--out`` also writes every number to a JSON file.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM, published (dense): HBM3 bandwidth and the f32 rate outside the
# tensor cores.  The kernels use FFMA only, so f32 is their operation type.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

ATTN_TOL = 1e-4          # kernel vs plain attention, abs and rel
LOGITS_TOL = 2e-3        # full-width logits, relative to max |logit|
L2_BYTES = 50 * 2 ** 20
ITERS = 50               # timed calls per kernel measurement
SLEEP_CYCLES = 60_000_000  # ~30 ms at H100 clocks: covers host queuing
HOST_GAPS: list[str] = []  # measurements whose queuing outlasted the sleep


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time in ms for the work, and which resource sets it."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def time_ms(torch, fn, arg_sets, iters: int) -> float:
    """Mean device ms per call over `iters` calls cycling through `arg_sets`
    (sets large enough together to leave L2 cold for each call), after
    warm-up.  A device-side sleep holds the stream while the host queues
    every timed call, so the events time the device alone, without the
    gaps of Python launch overhead; if queuing outlasts the sleep, the
    number is marked as including host gaps."""
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    e0, t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    e0.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    h0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    host_ms = (time.perf_counter() - h0) * 1e3
    t1.record()
    torch.cuda.synchronize()
    if host_ms >= e0.elapsed_time(t0):
        HOST_GAPS.append(getattr(fn, "__name__", "fn"))
        log(f"[time] note: queuing took {host_ms:.2f} ms, longer than the "
            f"sleep; this number includes host gaps")
    return t0.elapsed_time(t1) / iters


def copies_for(nbytes: int, cap: int = 48) -> int:
    """How many input copies make one cycle exceed twice the L2 cache."""
    return max(2, min(cap, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(0)
        self.kernels: dict[str, dict] = {}
        self.details: dict[str, object] = {}

    # ---- helpers ---------------------------------------------------------
    def randn(self, *shape, scale=1.0):
        return self.torch.randn(shape, generator=self.gen, device=self.dev) \
            * scale

    def record(self, name, **kw):
        self.kernels.setdefault(name, {}).update(kw)

    def err(self, name, value):
        rec = self.kernels.setdefault(name, {})
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), float(value))

    # ---- phase 2: kernels vs plain versions ------------------------------
    def check_codec(self):
        torch = self.torch
        from repro_torch.core.types import P8_0, P8_2, P16_1, P16_2
        from repro_torch.kernels import posit_codec as C
        for cfg in (P16_2, P16_1, P8_2, P8_0):
            dt = getattr(torch, cfg.storage_dtype_name)
            pats = torch.arange(-(1 << (cfg.n - 1)), 1 << (cfg.n - 1),
                                device=self.dev, dtype=torch.int32).to(dt)
            got = C.decode_block(pats, cfg)
            want = C.decode_block_plain(pats, cfg)
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            log(f"[codec] decode {cfg}: {pats.numel()} patterns, {bad} "
                f"bit mismatches (bit-exact required)")
            if bad:
                raise AssertionError(f"decode_block {cfg}: {bad} mismatches")
            sweep = self._f32_sweep(want)
            got = C.encode_block(sweep, cfg)
            want_e = C.encode_block_plain(sweep, cfg)
            bad = int((got != want_e).sum())
            log(f"[codec] encode {cfg}: {sweep.numel()} f32 values (+-0, "
                f"subnormals, Inf, NaN, random bits, posit values +-1 ulp), "
                f"{bad} mismatches (bit-exact required)")
            if bad:
                raise AssertionError(f"encode_block {cfg}: {bad} mismatches")
        self.err("decode_block", 0.0)
        self.err("encode_block", 0.0)

    def _f32_sweep(self, values):
        torch = self.torch
        specials = torch.tensor(
            [0, -2 ** 31, 0x7F800000, -8388608, 0x7FC00000, 1, -2 ** 31 + 1,
             0x007FFFFF, 0x00400000, 0x7F7FFFFF, -8388609],
            dtype=torch.int64, device=self.dev).to(torch.int32)
        rand = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << 20,),
                             generator=self.gen, device=self.dev,
                             dtype=torch.int64).to(torch.int32)
        subn = torch.arange(1, 1 << 23, 4099, device=self.dev,
                            dtype=torch.int32)
        v = values[torch.isfinite(values)]
        inf = torch.tensor(float("inf"), device=self.dev)
        near = torch.cat([v, torch.nextafter(v, inf),
                          torch.nextafter(v, -inf)])
        vs = torch.sort(v).values
        mids = (vs[1:] + vs[:-1]) / 2
        return torch.cat([specials.view(torch.float32),
                          rand.view(torch.float32),
                          subn.view(torch.float32), near, mids])

    def check_append(self):
        torch = self.torch
        from repro_torch.core.types import P8_2, P16_2
        from repro_torch.kernels import posit_codec as C
        B, n_kv, S, D, page, W, P = 8, 5, 128, 64, 16, 34, 300
        sl = torch.tensor([0, 16, 37, 128, 200, 300, 411, 500],
                          dtype=torch.int32, device=self.dev)
        nn = torch.tensor([128, 128, 91, 0, 128, 17, 128, 128],
                          dtype=torch.int32, device=self.dev)
        table = torch.randperm(P - 1, generator=self.gen, device=self.dev)
        table = (table[:B * W] + 1).reshape(B, W).to(torch.int32)
        k, v = self.randn(B, n_kv, S, D), self.randn(B, n_kv, S, D)
        for cfg in (P16_2, P8_2, None):
            dt = (torch.float32 if cfg is None
                  else getattr(torch, cfg.storage_dtype_name))
            pools = [torch.zeros((P, n_kv, page, D), dtype=dt,
                                 device=self.dev) for _ in range(4)]
            C.paged_append(k, v, pools[0], pools[1], table, sl, nn, cfg)
            C.paged_append_plain(k, v, pools[2], pools[3], table, sl, nn, cfg)
            bad = sum(int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                      for a, b in ((pools[0], pools[2]),
                                   (pools[1], pools[3])))
            log(f"[append] {cfg or 'float'} pages, [8,5,128,64] with masked "
                f"tokens and positions past the table: {bad} byte "
                f"mismatches (bit-exact required)")
            if bad:
                raise AssertionError(f"paged_append {cfg}: {bad} mismatches")
        self.err("paged_append", 0.0)

    def check_gemm(self):
        torch = self.torch
        from repro_torch.core.types import P8_2, P16_2
        from repro_torch.kernels import posit_gemm as G
        from repro_torch.kernels import ref
        worst = 0.0
        for cfg in (P16_2, P8_2):
            for name, K, N, tb in GEMM_SHAPES:
                wshape = (N, K) if tb else (K, N)
                w = ref.encode_ref(self.randn(*wshape, scale=K ** -0.5), cfg)
                wf = ref.decode_ref(w, cfg)
                wf = wf.T if tb else wf
                for M in (1, 8, 24, 512, 1024):
                    x = self.randn(M, K)
                    got = G.pw_gemm(x, w, cfg, transpose_b=tb)
                    want = G.pw_gemm_plain(x, w, cfg, tb)
                    # f32 dot products of length K differ by at most
                    # 2*K*2^-24 * (|x| @ |w|) between any two orders
                    tol = 2 * K * 2.0 ** -24 * (x.abs() @ wf.abs())
                    diff = (got - want).abs()
                    ratio = float((diff / (tol + 1e-30)).max())
                    worst = max(worst, ratio)
                    self.err("pw_gemm", diff.max())
                    log(f"[gemm] {cfg} {name} M={M} K={K} N={N}: max|err| "
                        f"{float(diff.max()):.3e}, worst err/bound "
                        f"{ratio:.3e}")
                    if ratio > 1.0:
                        raise AssertionError(f"pw_gemm {cfg} {name} M={M}: "
                                             f"error above the f32 bound")
        self.details["gemm_worst_err_over_bound"] = worst

    def _pool(self, cfg, P, n_kv, page, D):
        from repro_torch.kernels import ref
        k = self.randn(P, n_kv, page, D)
        v = self.randn(P, n_kv, page, D)
        if cfg is None:
            return k, v
        return ref.encode_ref(k, cfg), ref.encode_ref(v, cfg)

    def _table(self, B, W, P):
        """Distinct pages per sequence; tails point anywhere (garbage)."""
        torch = self.torch
        perm = torch.randperm(P - 1, generator=self.gen, device=self.dev) + 1
        return perm[:B * W].reshape(B, W).to(torch.int32)

    def _compare_attn(self, name, label, got, want, live, dead_zero):
        """Rows in `live` must agree within ATTN_TOL.  With dead_zero, the
        other rows see no key and must be exactly 0 from the kernel;
        otherwise they are garbage by contract and not compared."""
        diff = (got - want).abs()[live]
        lim = ATTN_TOL * (1 + want.abs()[live])
        ok = bool((diff <= lim).all())
        dead_ok = not dead_zero or bool((got[~live] == 0).all())
        self.err(name, diff.max() if diff.numel() else 0.0)
        log(f"[{name}] {label}: max|err| "
            f"{float(diff.max()) if diff.numel() else 0.0:.3e} "
            f"(tol {ATTN_TOL} abs+rel){'' if dead_ok else ' DEAD ROWS != 0'}")
        if not (ok and dead_ok):
            raise AssertionError(f"{name} {label}: kernel disagrees")

    def check_attention(self):
        torch = self.torch
        from repro_torch.core.types import P8_2, P16_2
        from repro_torch.kernels import flash_attention as F
        B, H, n_kv, page, D, W, P = 8, 15, 5, 16, 64, 34, 400
        for cfg in (P16_2, P8_2, None):
            kp, vp = self._pool(cfg, P, n_kv, page, D)
            table = self._table(B, W, P)
            fmt = cfg or "float"
            sl = torch.tensor([1, 17, 128, 300, 512, 544, 0, 33],
                              dtype=torch.int32, device=self.dev)
            q = self.randn(B, H, D)
            live = (sl > 0)[:, None, None].expand(B, H, D)
            for window in (None, 64):
                got = F.paged_flash_decode(q, kp, vp, table, sl, cfg_kv=cfg,
                                           window=window)
                want = F.paged_flash_decode_plain(q, kp, vp, table, sl,
                                                  cfg_kv=cfg, window=window)
                self._compare_attn("paged_flash_decode",
                                   f"{fmt} window={window}", got, want, live,
                                   dead_zero=True)
            for Sq in (1, 64, 128):
                qo = torch.tensor([0, 16, 37, 128, 256, 400, 0, 5],
                                  dtype=torch.int32, device=self.dev)
                nn = torch.tensor([Sq, Sq, max(1, Sq - 9), Sq, Sq, Sq,
                                   max(1, Sq // 2), Sq], dtype=torch.int32,
                                  device=self.dev)
                sl = qo + nn
                q = self.randn(B, H, Sq, D)
                rows = torch.arange(Sq, device=self.dev)
                live = (rows[None, :] < nn[:, None])[:, None, :, None]
                live = live.expand(B, H, Sq, D)
                for window, softcap in ((None, None), (48, None),
                                        (None, 30.0)):
                    got = F.paged_flash_prefill(q, kp, vp, table, sl, qo,
                                                cfg_kv=cfg, window=window,
                                                softcap=softcap)
                    want = F.paged_flash_prefill_plain(
                        q, kp, vp, table, sl, qo, cfg_kv=cfg, window=window,
                        softcap=softcap)
                    # rows past a sequence's chunk are garbage by contract
                    self._compare_attn(
                        "paged_flash_prefill",
                        f"{fmt} Sq={Sq} window={window} softcap={softcap}",
                        got, want, live, dead_zero=False)

    # ---- phase 2b: timings at the main path's shapes ---------------------
    def time_kernels(self):
        torch = self.torch
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import flash_attention as F
        from repro_torch.kernels import posit_codec as C
        from repro_torch.kernels import posit_gemm as G
        from repro_torch.kernels import ref
        cfg = P16_2
        it = ITERS

        # K1 decode: the embedding rows of one prefill step [8, 128, 960]
        shape = (8, 128, 960)
        n = math.prod(shape)
        sets = [(ref.encode_ref(self.randn(*shape), cfg), cfg)
                for _ in range(copies_for(6 * n, 16))]
        b, by = bound(6 * n, 0)
        self.record("decode_block", shape="embed rows [8,128,960] p16",
                    ms=time_ms(torch, C.decode_block, sets, it),
                    plain_ms=time_ms(torch, C.decode_block_plain, sets, 20),
                    bound_ms=b, bound_by=by, library_ms=None)

        # K1 encode: PTQ of one w_up matrix [960, 2560]
        shape = (960, 2560)
        n = math.prod(shape)
        sets = [(self.randn(*shape), cfg) for _ in range(copies_for(6 * n,
                                                                    16))]
        b, by = bound(6 * n, 0)
        self.record("encode_block", shape="PTQ of w_up [960,2560] -> p16",
                    ms=time_ms(torch, C.encode_block, sets, it),
                    plain_ms=time_ms(torch, C.encode_block_plain, sets, 20),
                    bound_ms=b, bound_by=by, library_ms=None)

        # K1 append: one prefill step's K and V, [8, 5, 128, 64] each
        B, n_kv, S, D, page, W, P = 8, 5, 128, 64, 16, 34, 273
        table = self._table(B, W, P)
        sl = torch.full((B,), 128, dtype=torch.int32, device=self.dev)
        nn = torch.full((B,), S, dtype=torch.int32, device=self.dev)
        pools = [self._pool(cfg, P, n_kv, page, D) for _ in range(4)]
        sets = [(self.randn(B, n_kv, S, D), self.randn(B, n_kv, S, D),
                 kp, vp, table, sl, nn, cfg) for kp, vp in pools]
        n = B * n_kv * S * D
        b, by = bound(2 * n * (4 + 2) + 2 * B * 4 + table.numel() * 4, 0)
        self.record("paged_append",
                    shape="prefill step K,V [8,5,128,64] f32 -> p16 pages",
                    ms=time_ms(torch, C.paged_append, sets, it),
                    plain_ms=time_ms(torch, C.paged_append_plain, sets, 20),
                    bound_ms=b, bound_by=by, library_ms=None)

        # K2: one decode step's 225 GEMMs (M = 8), cold weights
        per_step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                    "bytes": 0.0, "flops": 0.0}
        rows = []
        for name, K, N, tb in GEMM_SHAPES:
            count = 1 if name == "unembed" else 32 * GEMM_PER_LAYER[name]
            wshape = (N, K) if tb else (K, N)
            nw = copies_for(2 * K * N, 24)
            ws = [ref.encode_ref(self.randn(*wshape, scale=K ** -0.5), cfg)
                  for _ in range(nw)]
            wfs = [ref.decode_ref(w, cfg) for w in ws[:copies_for(4 * K * N,
                                                                  12)]]
            for M in (8, 1024):
                x = self.randn(M, K)
                kern = time_ms(torch, lambda w: G.pw_gemm(
                    x, w, cfg, transpose_b=tb), [(w,) for w in ws], it)
                plain = time_ms(torch, lambda w: G.pw_gemm_plain(
                    x, w, cfg, tb), [(w,) for w in ws], 10)
                lib = time_ms(torch, lambda wf: torch.matmul(
                    x, wf.T if tb else wf), [(w,) for w in wfs], it)
                nbytes = 4 * M * K + 2 * K * N + 4 * M * N
                b, by = bound(nbytes, 2.0 * M * K * N)
                rows.append({"shape": name, "M": M, "K": K, "N": N,
                             "per_step": count, "ms": kern,
                             "plain_ms": plain, "library_ms": lib,
                             "bound_ms": b, "bound_by": by})
                log(f"[time] pw_gemm {name} M={M}: {kern:.4f} ms (plain "
                    f"{plain:.4f}, torch.matmul on f32 {lib:.4f}, bound "
                    f"{b:.4f} by {by})")
                if M == 8:
                    per_step["ms"] += count * kern
                    per_step["plain_ms"] += count * plain
                    per_step["library_ms"] += count * lib
                    per_step["bytes"] += count * nbytes
                    per_step["flops"] += count * 2.0 * M * K * N
            del ws, wfs
        self.details["pw_gemm_shapes"] = rows
        b, by = bound(per_step["bytes"], per_step["flops"])
        self.record("pw_gemm",
                    shape="one decode step: 225 GEMMs at M=8 (7 per layer x "
                          "32 + unembed), p16 weights, cold",
                    ms=per_step["ms"], plain_ms=per_step["plain_ms"],
                    library_ms=per_step["library_ms"], bound_ms=b,
                    bound_by=by)

        # K3: one layer of a decode step, 8 sequences at 128..544 tokens
        B, H, n_kv, page, D, W, P = 8, 15, 5, 16, 64, 34, 273
        G_ = H // n_kv
        sl = torch.tensor([160, 224, 300, 356, 420, 480, 512, 544],
                          dtype=torch.int32, device=self.dev)
        table = self._table(B, W, P)
        toks = int(sl.sum())
        nbytes = 2 * toks * n_kv * D * 2 + 2 * B * H * D * 4 + B * 4
        pools = [self._pool(cfg, P, n_kv, page, D)
                 for _ in range(copies_for(nbytes, 24))]
        q = self.randn(B, H, D)
        sets = [(q, kp, vp, table, sl) for kp, vp in pools]
        b, by = bound(nbytes, 4.0 * toks * H * D)
        kern = time_ms(torch, lambda *a: F.paged_flash_decode(
            *a, cfg_kv=cfg), sets, it)
        plain = time_ms(torch, lambda *a: F.paged_flash_decode_plain(
            *a, cfg_kv=cfg), sets, 10)
        lib = self._sdpa_ms(pools, table, sl, q[:, :, None, :],
                            sl - 1, causal=True)
        self.record("paged_flash_decode",
                    shape="one layer, decode step: 8 seqs, 160..544 tokens, "
                          "p16 pages",
                    ms=kern, plain_ms=plain, library_ms=lib, bound_ms=b,
                    bound_by=by)

        # K4: one layer of a prefill step, 8 x 128-query chunks mid-prompt
        Sq = 128
        qo = torch.tensor([0, 128, 256, 384, 0, 128, 256, 384],
                          dtype=torch.int32, device=self.dev)
        sl = qo + Sq
        keys = int(((qo + torch.arange(1, Sq + 1, device=self.dev)[:, None]
                     ).sum()))           # causal keys over all query rows
        toks = int(sl.sum())
        nbytes = (2 * toks * n_kv * D * 2 + 2 * B * H * Sq * D * 4
                  + 2 * B * 4)
        q = self.randn(B, H, Sq, D)
        sets = [(q, kp, vp, table, sl, qo) for kp, vp in pools]
        b, by = bound(nbytes, 4.0 * keys * H * D)
        kern = time_ms(torch, lambda *a: F.paged_flash_prefill(
            *a, cfg_kv=cfg), sets, it)
        plain = time_ms(torch, lambda *a: F.paged_flash_prefill_plain(
            *a, cfg_kv=cfg), sets, 5)
        lib = self._sdpa_ms(pools, table, sl, q, qo, causal=True)
        self.record("paged_flash_prefill",
                    shape="one layer, prefill step: 8 x 128 queries at "
                          "offsets 0..384, p16 pages",
                    ms=kern, plain_ms=plain, library_ms=lib, bound_ms=b,
                    bound_by=by)

    def _sdpa_ms(self, pools, table, sl, q, qo, causal):
        """One scaled_dot_product_attention call over the gathered, decoded
        dense KV (GQA grouped, masks as the kernel's): the library
        yardstick, timed only."""
        torch = self.torch
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import ref
        sets = []
        for kp, vp in pools[:4]:
            k = ref.decode_ref(ref.gather_pages(kp, table), P16_2)
            v = ref.decode_ref(ref.gather_pages(vp, table), P16_2)
            Skv, Sq = k.shape[2], q.shape[2]
            kpos = torch.arange(Skv, device=self.dev)
            qpos = qo[:, None] + torch.arange(Sq, device=self.dev)[None, :]
            mask = kpos[None, None, :] < sl[:, None, None]
            if causal:
                mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
            sets.append((q, k, v, mask[:, None]))
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def fn(q, k, v, m):
            return sdpa(q, k, v, attn_mask=m, enable_gqa=True)

        return time_ms(torch, fn, sets, ITERS)

    # ---- phase 3: the main path ------------------------------------------
    def serve(self):
        torch = self.torch
        import numpy as np
        from repro_torch import configs
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import ops
        from repro_torch.models.transformer import init_params
        from repro_torch.quant.policy import PositPolicy
        from repro_torch.quant.ptq import quantize_for_serving
        from repro_torch.serving.engine import PagedServingEngine

        cfg = configs.get_config("smollm-360m",
                                 policy=PositPolicy(weights=P16_2,
                                                    kv_cache=P16_2))
        params = init_params(cfg, seed=0, device="cuda")
        rng = np.random.default_rng(1)
        lens = rng.integers(128, 513, 16)
        reqs = [(rng.integers(0, cfg.vocab, int(n)).astype(np.int32), 32)
                for n in lens]
        width = -(-(512 + 32) // 16)
        torch.cuda.synchronize()

        # ---- the counted run: PTQ + engine + drain ----
        ops.reset_counters()
        qparams = quantize_for_serving(params, P16_2)
        del params
        eng = PagedServingEngine(qparams, cfg, max_seqs=8, page_size=16,
                                 prefill_chunk=128, table_width=width,
                                 device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        plain = ops.plain_counts()
        # ---- end of the counted run ----

        stats = eng.stats()
        bad = [r for r in range(len(reqs))
               if r not in out or len(out[r]) != 32]
        if bad or stats["failed_nar"] or stats["completed"] != len(reqs):
            raise AssertionError(f"serving: requests {bad} incomplete; "
                                 f"stats {stats}")
        missing = [k for k, n in launches.items() if n == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main "
                                 f"path: {missing}")
        if any(plain.values()):
            raise AssertionError(f"plain versions ran on the main path: "
                                 f"{plain}")
        steps = stats["prefill_steps"] + stats["decode_steps"]
        gemms = 7 * cfg.n_layers + 1          # 7 per layer + the unembed
        expect = {"pw_gemm": gemms * steps,
                  "paged_flash_decode": cfg.n_layers * stats["decode_steps"],
                  "paged_flash_prefill": cfg.n_layers * stats["prefill_steps"],
                  "paged_append": cfg.n_layers * steps,
                  "decode_block": steps, "encode_block": gemms}
        if {k: launches[k] for k in expect} != expect:
            raise AssertionError(f"launch counts {launches} differ from "
                                 f"the path's structure {expect}")
        for name, n in launches.items():
            self.record(name, launches=n)

        def nbytes(tree):
            if isinstance(tree, dict):
                return sum(nbytes(v) for v in tree.values())
            if isinstance(tree, (list, tuple)):
                return sum(nbytes(v) for v in tree)
            t = getattr(tree, "bits", tree)
            return t.numel() * t.element_size()

        n_tok = sum(len(v) for v in out.values())
        dec = np.asarray(eng.step_times["decode"]) * 1e3
        pre = np.asarray(eng.step_times["prefill"]) * 1e3
        ttft = np.asarray(list(eng.ttft_s.values())) * 1e3
        serving = {
            "requests": len(reqs), "tokens": n_tok, "drain_s": drain_s,
            "tok_per_s": n_tok / drain_s, "ttft_mean_ms": float(ttft.mean()),
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "decode_step_p50_ms": float(np.percentile(dec, 50)),
            "decode_step_p90_ms": float(np.percentile(dec, 90)),
            "prefill_step_p50_ms": float(np.percentile(pre, 50)),
            "prefill_steps": stats["prefill_steps"],
            "decode_steps": stats["decode_steps"],
            "preempted": stats["preempted"],
            "weights_bytes": nbytes(qparams),
            "pool_bytes": nbytes(eng.pages), "launches": launches,
            "prompt_lens": [int(n) for n in lens],
        }
        self.details["serving"] = serving
        card = self.details["gpu"]
        log(f"[serve] smollm-360m full width, p16 weights + KV, 16 requests "
            f"(prompts 128..512, max_new 32, greedy), max_seqs=8, page=16, "
            f"chunk=128 on {card}")
        log(f"[serve] {n_tok} tokens in {drain_s:.3f} s = "
            f"{serving['tok_per_s']:.1f} tok/s; mean TTFT "
            f"{serving['ttft_mean_ms']:.1f} ms; decode step p50 "
            f"{serving['decode_step_p50_ms']:.3f} ms; prefill step p50 "
            f"{serving['prefill_step_p50_ms']:.2f} ms; "
            f"{stats['prefill_steps']} prefill + {stats['decode_steps']} "
            f"decode steps ({card})")
        log(f"[serve] weights {serving['weights_bytes'] / 1e6:.1f} MB, pool "
            f"{serving['pool_bytes'] / 1e6:.1f} MB ({card})")
        return qparams, cfg, reqs

    def trace_decode(self, qparams, cfg, reqs):
        """Decode steps outside the counted run: 8 slots decoding
        (128-token prompts), 8 steps timed on the host clock and then 8
        more under torch.profiler.  Reports kernel launches per step,
        device time by kernel, and the device's busy share twice: the
        profiled window's device time over that window's own wall time (a
        lower bound: the profiler adds host cost) and over the unprofiled
        window's wall time (the same slots, 8 tokens earlier)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.serving.engine import PagedServingEngine
        eng = PagedServingEngine(qparams, cfg, max_seqs=8, page_size=16,
                                 prefill_chunk=128, table_width=16,
                                 device="cuda")
        for prompt, _ in reqs[:8]:
            eng.submit(prompt[:128], 24)
        while eng.waiting or any(s is not None and s.phase == "prefill"
                                 for s in eng.slots):
            eng.step()
        eng.step()                                # one warm decode step
        steps = 8
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        plain_wall_us = (time.perf_counter() - t0) * 1e6
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name: dict[str, list] = {}
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.events():
            if getattr(e, "device_type", None) != cuda:
                continue
            name = e.name
            rec = by_name.setdefault(name, [0.0, 0])
            rec[0] += e.time_range.elapsed_us()
            rec[1] += 1
        busy_us = sum(v[0] for v in by_name.values())
        launches = sum(v[1] for v in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        trace = {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
                 "unprofiled_wall_ms_per_step": plain_wall_us / steps / 1e3,
                 "device_busy_ms_per_step": busy_us / steps / 1e3,
                 "device_busy_share": busy_us / wall_us if busy_us else None,
                 "device_busy_share_unprofiled":
                     busy_us / plain_wall_us if busy_us else None,
                 "device_launches_per_step": launches / steps,
                 "top_kernels_ms_per_step": {
                     k[:80]: v[0] / steps / 1e3 for k, v in top}}
        self.details["decode_trace"] = trace
        if not busy_us:
            log("[trace] the profiler saw no device time: busy share not "
                "measured")
            return
        log(f"[trace] decode steps under torch.profiler: wall "
            f"{trace['wall_ms_per_step']:.2f} ms/step, device busy "
            f"{trace['device_busy_ms_per_step']:.2f} ms/step (share "
            f"{trace['device_busy_share']:.3f}; of the "
            f"{trace['unprofiled_wall_ms_per_step']:.2f} ms unprofiled step "
            f"just before: {trace['device_busy_share_unprofiled']:.3f}), "
            f"{trace['device_launches_per_step']:.0f} device kernels/step "
            f"({self.details['gpu']})")
        for k, v in trace["top_kernels_ms_per_step"].items():
            log(f"[trace]   {v:8.3f} ms/step  {k}")

    def check_logits(self, qparams, cfg, reqs):
        """The kernel path's logits against the plain path's on the CPU,
        same weights: a 16-token prefill, then one decode step on the
        prompt's 17th token."""
        torch = self.torch
        import numpy as np
        from repro_torch.models.transformer import (assemble_paged_caches,
                                                    forward,
                                                    init_paged_pages)

        def to(tree, dev):
            if isinstance(tree, dict):
                return {k: to(v, dev) for k, v in tree.items()}
            if isinstance(tree, list):
                return [to(v, dev) for v in tree]
            return tree.to(dev)

        def run(params, dev):
            toks = torch.from_numpy(reqs[0][0][:16][None]).to(dev)
            nxt = torch.from_numpy(reqs[0][0][16:17][None]).to(dev)
            pages = init_paged_pages(cfg, 3, 16, device=dev)
            table = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
            z = torch.zeros(1, dtype=torch.int32, device=dev)
            with torch.inference_mode():
                caches = assemble_paged_caches(pages, table, z, z + 16)
                l1, _, caches = forward(params, cfg, tokens=toks,
                                        caches=caches)
                pages = {"layers": [{"k_pages": c["k_pages"],
                                     "v_pages": c["v_pages"]}
                                    for c in caches["layers"]]}
                caches = assemble_paged_caches(pages, table, z + 16, z + 1)
                l2, _, _ = forward(params, cfg, tokens=nxt, caches=caches)
            return torch.cat([l1[0, -1:], l2[0]]).float().cpu()

        gpu = run(qparams, self.dev)
        cpu = run(to(qparams, "cpu"), "cpu")
        rel = float((gpu - cpu).abs().max() / cpu.abs().max())
        same = bool((gpu.argmax(-1) == cpu.argmax(-1)).all())
        self.details["full_width_logits_rel_err"] = rel
        log(f"[check] full-width logits, kernels on the card vs plain on the "
            f"CPU: max|diff|/max|logit| = {rel:.3e} (tol {LOGITS_TOL}); "
            f"argmax equal: {same}")
        if not (np.isfinite(rel) and rel <= LOGITS_TOL):
            raise AssertionError("full-width logits disagree")

    def check_smoke_drain(self):
        """A smoke-size drain with preemption on the card (kernels) and on
        the CPU (plain versions), same weights: identical greedy tokens."""
        import numpy as np
        from repro_torch import configs
        from repro_torch.core.types import P8_2, P16_2
        from repro_torch.models.transformer import init_params
        from repro_torch.quant.policy import PositPolicy
        from repro_torch.quant.ptq import quantize_for_serving
        from repro_torch.serving.engine import PagedServingEngine
        rng = np.random.default_rng(7)
        reqs = [(rng.integers(0, 512, n).astype(np.int32), 8)
                for n in (5, 17, 9, 23, 3, 12)]
        kw = dict(max_seqs=3, page_size=4, table_width=10, num_pages=12,
                  prefill_chunk=8)
        for pcfg in (P16_2, P8_2, None):
            pol = (PositPolicy(weights=pcfg, kv_cache=pcfg) if pcfg
                   else PositPolicy())
            cfg = configs.get_smoke("smollm-360m", policy=pol)
            outs = []
            for dev in ("cuda", "cpu"):
                params = init_params(cfg, seed=0, device="cpu")
                params = self._to(params, dev)
                if pcfg is not None:
                    params = quantize_for_serving(params, pcfg)
                eng = PagedServingEngine(params, cfg, device=dev, **kw)
                outs.append((eng.run(list(reqs)), eng.counters["preempted"]))
            (a, pa), (b, pb) = outs
            same = sorted(a) == sorted(b) and all(
                np.array_equal(a[r], b[r]) for r in a)
            log(f"[check] smoke drain {pcfg or 'float'}: card vs CPU greedy "
                f"tokens identical: {same} (preempted {pa}/{pb})")
            if not same or pa < 1:
                raise AssertionError("smoke drain: card and CPU disagree")

    def _to(self, tree, dev):
        if isinstance(tree, dict):
            return {k: self._to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self._to(v, dev) for v in tree]
        return tree.to(dev)


# (name, K, N, transpose_b) of the GEMMs of one smollm-360m layer + unembed
GEMM_SHAPES = [("wq/wo", 960, 960, False), ("wk/wv", 960, 320, False),
               ("w_up/w_gate", 960, 2560, False), ("w_down", 2560, 960, False),
               ("unembed", 960, 49152, True)]
GEMM_PER_LAYER = {"wq/wo": 2, "wk/wv": 2, "w_up/w_gate": 2, "w_down": 1}

KERNEL_META = {
    "decode_block": ("src/repro_torch/csrc/posit_codec.cu",
                     "src/repro/kernels/posit_codec.py:41"),
    "encode_block": ("src/repro_torch/csrc/posit_codec.cu",
                     "src/repro/kernels/posit_codec.py:59"),
    "paged_append": ("src/repro_torch/csrc/posit_codec.cu",
                     "src/repro/kernels/posit_codec.py:59"),
    "pw_gemm": ("src/repro_torch/csrc/posit_gemm.cu",
                "src/repro/kernels/posit_gemm.py:158"),
    "paged_flash_decode": ("src/repro_torch/csrc/paged_attention.cu",
                           "src/repro/kernels/flash_attention.py:650"),
    "paged_flash_prefill": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/flash_attention.py:259"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write every number "
                    "to this JSON file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU only",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import resolve_device
    from repro_torch.kernels import build

    card = gpu_line()
    log(card)
    resolve_device("cuda")                      # pins TF32 off
    log(f"[build] {build.build_all():.1f} s (nvcc, sm_90a, in parallel); "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    s = Smoke(torch)
    s.details["gpu"] = card
    t0 = time.perf_counter()
    s.check_codec()
    s.check_append()
    s.check_gemm()
    s.check_attention()
    log(f"[phase] kernel checks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s.time_kernels()
    log(f"[phase] kernel timings {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    qparams, cfg, reqs = s.serve()
    log(f"[phase] serving {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s.trace_decode(qparams, cfg, reqs)
    log(f"[phase] decode trace {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s.check_logits(qparams, cfg, reqs)
    del qparams
    s.check_smoke_drain()
    log(f"[phase] output checks {time.perf_counter() - t0:.1f} s")

    s.details["timings_with_host_gaps"] = HOST_GAPS
    rows = []
    for name, (source, replaces) in KERNEL_META.items():
        rec = s.kernels[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": rec["launches"],
                     "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                     "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                     "bound_by": rec["bound_by"],
                     "library_ms": rec["library_ms"], "shape": rec["shape"]})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"gpu": card, "kernels": rows, **s.details}, f,
                      indent=1)
    # the main path's own counts, read right after the counted drain
    log("kernels: " + json.dumps(s.details["serving"]["launches"]))
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
