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
2d. the training kernels against their plain versions on the card: the
   contiguous flash prefill with its log-sum-exp (K7), the backward's dQ
   (K8) and dK/dV (K9) passes at the training shape ([8,15,512,64]
   causal) and an edge shape (128 queries over 512 keys, per-batch
   q_offset and kv_len, window 64, softcap 30, f32 and posit16 KV), and
   posit_gemm's transpose_a (the dW leg) at the step's five dW shapes and
   one posit16 A, each within an f32 error bound derived in the check;
   their timings beside the plain versions, SDPA and torch.matmul;
2c. the paper's arithmetic: the elementwise and divide kernels bit-exact
   against their plain versions (every posit8 pair at es 0..4, every
   posit8es2 fma triple, 2^26 seeded posit16 pairs and the edge patterns
   against all 65,536), Table II's wrong-% on the card, the quire GEMM
   (posit16 in and out, M = 1024 at smollm-360m's shapes) against its
   plain version, their timings, and the arithmetic main path: `pnp` arrays
   of 2^26 posit16 lanes through every operator and the GEMM, counters
   zeroed just before and read just after;
3. the serving main path: full-width smollm-360m from the port's seeded init,
   post-training quantized to posit16 (weights and KV), serving 16
   requests through PagedServingEngine with every launch counter zeroed
   just before and read just after; then the kernel path's logits against
   the plain path's on the CPU, and a smoke-size drain on the card against
   the same drain on the CPU, token for token; between them, 8 decode
   steps under torch.profiler (outside the counted run) for the device's
   busy share;
5. the training main path: (a) one step of smollm-360m at full width and
   depth 2 (posit16 STE weights), loss and every gradient on the card
   against the plain versions on the CPU; (b) `train_loop` at full width
   (32 layers) for 8 steps of 8 x 512 tokens with posit16 STE weights and
   8 with f32 weights, counters zeroed just before each and read just
   after (loss curves, step time, tokens/s, peak memory, launches per
   step, no plain call), then one profiled step for the busy share; (c)
   at depth 2, 4 steps + checkpoint + 4 resumed steps bit-identical to 8
   uninterrupted ones;
4. ``kernels: {...}`` with each kernel's launches on its main path, the
   card's name and power limit, one JSON line of per-kernel numbers, and
   last the contract line ``{"ok": true, "device": {...}}``.

Float32 matmuls run in full f32 here and in the port (TF32 off).
``--out`` also writes every number to a JSON file.
"""
from __future__ import annotations

import argparse
import dataclasses
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
ARITH_LANES = 1 << 26    # elementwise/divide lanes: 128 MB per p16 operand
DIV_MODES = ("exact", "poly", "poly_corrected", "pacogen")
PACOGEN_NR = {8: 0, 16: 1}   # the paper's Table II NR rounds for the LUT
LOGITS_TOL = 2e-3        # full-width logits, relative to max |logit|
# one depth-2 full-width training step, card (kernels) vs CPU (plain): the
# loss is a mean of log-sum-exps over 960-long f32 dot products (~1e-6
# relative apart in two summation orders); the gradients sum over up to
# 49,152 (the unembedding's dX) or 4,096 (every dW) products, whose f32
# sums in two orders typically differ by ~sqrt(K) 2^-24 ~ 1e-5 of the
# leaf's scale and at worst by 2 K 2^-24 ~ 6e-3 of its absolute sum.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-3    # of each gradient leaf's max |g|
TRAIN_STEPS = 8
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


def gpu_max_sm_clock_mhz() -> float:
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(res.stdout.strip().splitlines()[0])


def sass_per_lane(lib_path: str, kernel: str, lanes: int):
    """SASS instructions per lane of one kernel instantiation, from
    `cuobjdump -sass` on the built library: the static instruction count
    of its main loop (the span of its longest backward branch: the 16-byte
    vector loop), over the `lanes` one pass of that loop handles.  A
    diagnostic, not a bound: it counts the kernel's own code, unrolled
    copies and branches no lane takes included.  Returns (count, method);
    raises when the count cannot be read."""
    import re
    from repro_torch.kernels.build import nvcc
    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    for chunk in out.split("Function : ")[1:]:
        if kernel not in chunk.split("\n", 1)[0]:
            continue
        ins = [(int(a, 16), text) for a, text in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", chunk)]
        span = 0
        for hi, text in ins:
            m = re.search(r"\bBRA\S*\s+(?:`\()?(0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < hi:
                lo = int(m.group(1), 16)
                span = max(span, sum(1 for x, _ in ins if lo <= x <= hi))
        if not span:
            raise RuntimeError(f"{kernel}: no loop found in its SASS")
        return span / lanes, (f"static SASS of the vector loop: {span} "
                              f"instructions / {lanes} lanes")
    raise RuntimeError(f"{kernel} not in the SASS of {lib_path}")


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time in ms for the work, and which resource sets it."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def time_ms(torch, fn, arg_sets, iters: int, label: str = "") -> float:
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
        label = label or getattr(fn, "__name__", "fn")
        HOST_GAPS.append(label)
        log(f"[time] note: queuing {label} took {host_ms:.2f} ms, longer "
            f"than the sleep; its number includes host gaps")
    return t0.elapsed_time(t1) / iters


def device_time_by_kernel(torch, prof) -> dict[str, list]:
    """Device time (us) and count of a torch.profiler run by kernel, with
    template arguments and parameter lists cut from the names, so that the
    instances of one kernel template add up under one name."""
    import re
    cuda = torch.autograd.DeviceType.CUDA
    by_name: dict[str, list] = {}
    for e in prof.events():
        if getattr(e, "device_type", None) != cuda:
            continue
        name = e.name.replace("(anonymous namespace)::", "")
        m = re.match(r"(?:void )?([\w:]+)", name)
        rec = by_name.setdefault(m.group(1) if m else name[:80], [0.0, 0])
        rec[0] += e.time_range.elapsed_us()
        rec[1] += 1
    return by_name


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
                at = f"{name} M={M}"
                kern = time_ms(torch, lambda w: G.pw_gemm(
                    x, w, cfg, transpose_b=tb), [(w,) for w in ws], it,
                    f"pw_gemm {at}")
                plain = time_ms(torch, lambda w: G.pw_gemm_plain(
                    x, w, cfg, tb), [(w,) for w in ws], 10,
                    f"pw_gemm_plain {at}")
                lib = time_ms(torch, lambda wf: torch.matmul(
                    x, wf.T if tb else wf), [(w,) for w in wfs], it,
                    f"torch.matmul {at}")
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
            *a, cfg_kv=cfg), sets, it, "paged_flash_decode")
        plain = time_ms(torch, lambda *a: F.paged_flash_decode_plain(
            *a, cfg_kv=cfg), sets, 10, "paged_flash_decode_plain")
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
            *a, cfg_kv=cfg), sets, it, "paged_flash_prefill")
        plain = time_ms(torch, lambda *a: F.paged_flash_prefill_plain(
            *a, cfg_kv=cfg), sets, 5, "paged_flash_prefill_plain")
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

        return time_ms(torch, fn, sets, ITERS, "sdpa")

    # ---- phase 2d: the training kernels against their plain versions -----
    def _attn_bounds(self, q, k, v, o, lse, do, kl, qo, cfg, causal, window,
                     softcap):
        """Per-element bounds on |kernel - plain| for K7-K9, each the f32
        dot-product bound of `check_gemm` carried through the attention:
        two f32 sums of the same n products in two orders
        differ by at most 2 * n * 2^-24 times the sum of their absolute
        values.  Scores contract D: eps_s = 2 D u (|q| . |k|) scale (plus
        4 u softcap for tanhf); p = exp(s - lse) is off by p (eps_s + 4 u)
        (expf's ulps); the output sums Skv keys (Skv + 8: the key sum and
        the exp, log and divide roundings), dQ sums Skv keys, dK and dV
        sum the G * Sq query rows of the group.  Both sides are given the
        same o and lse (the plain forward's) and compute the same delta,
        so the backward bounds carry no forward error."""
        torch = self.torch
        from repro_torch.kernels import ref
        u = 2.0 ** -24
        B, H, Sq, D = q.shape
        n_kv, Skv = k.shape[1], k.shape[2]
        G = H // n_kv
        scale = D ** -0.5
        ein = torch.einsum
        kf, vf = ref.values(k, cfg).abs(), ref.values(v, cfg)
        s, valid, dcap, _, qg = ref._prefill_scores(q, k, kl, qo, cfg,
                                                   causal, window, softcap)
        eps_s = 2 * D * u * ein("bngqd,bnkd->bngqk", qg.abs(), kf) * scale
        if softcap is not None:
            eps_s = eps_s + 4 * u * softcap
        lg = lse.reshape(B, n_kv, G, Sq, 1)
        p = torch.where(valid, torch.exp(s - lg), 0.0)
        pe = p * (eps_s + 4 * u)                      # |dp| per key
        va = vf.abs()
        og = o.reshape(B, n_kv, G, Sq, D)
        pv = ein("bngqk,bnkd->bngqd", p, va)
        out = (ein("bngqk,bnkd->bngqd", pe, va) + og.abs() * pe.sum(-1, True)
               + 2 * (Skv + 8) * u * pv)
        lse_b = pe.sum(-1) + 2 * (Skv + 8) * u * (1 + lg[..., 0].abs())
        dog = do.reshape(B, n_kv, G, Sq, D)
        dpd = (ein("bngqd,bnkd->bngqk", dog, vf)
               - (dog * og).sum(-1, keepdim=True)).abs()
        eps_dp = 2 * D * u * ein("bngqd,bnkd->bngqk", dog.abs(), va)
        dc = dcap.abs() if dcap is not None else 1.0
        e_ds = dc * (pe * dpd + p * eps_dp)
        if softcap is not None:                       # d(1 - t^2) = 2 t dt
            e_ds = e_ds + p * dpd * 2 * (s / softcap).abs() * eps_s / softcap
        ds = (p * dpd * dc).abs()
        dq = scale * (ein("bngqk,bnkd->bngqd", e_ds, kf)
                      + 2 * Skv * u * ein("bngqk,bnkd->bngqd", ds, kf))
        qa = qg.abs()
        dk = scale * (ein("bngqk,bngqd->bnkd", e_ds, qa)
                      + 2 * G * Sq * u * ein("bngqk,bngqd->bnkd", ds, qa))
        da = dog.abs()
        dv = (ein("bngqk,bngqd->bnkd", pe, da)
              + 2 * G * Sq * u * ein("bngqk,bngqd->bnkd", p, da))
        return {"out": out.reshape(B, H, Sq, D),
                "lse": lse_b.reshape(B, H, Sq),
                "dq": dq.reshape(B, H, Sq, D), "dk": dk, "dv": dv}

    def _within(self, name, label, got, want, tol):
        """|got - want| <= tol elementwise; returns the worst err/bound."""
        diff = (got - want).abs()
        ratio = float((diff / (tol + 1e-30)).max())
        self.err(name, diff.max())
        log(f"[{name}] {label}: max|err| {float(diff.max()):.3e}, worst "
            f"err/bound {ratio:.3e}")
        if ratio > 1.0:
            raise AssertionError(f"{name} {label}: error above the stated "
                                 f"f32 bound")
        return ratio

    def check_training_kernels(self):
        """K7-K9 at the training shape ([8,15,512,64] queries over
        [8,5,512,64] f32 KV, causal) and at an edge shape (128 queries
        over 512 keys, per-batch q_offset and kv_len < Skv, window 64,
        softcap 30; f32 and posit16 KV), each against its plain version
        within the bounds of `_attn_bounds`; rows that see no key must be
        exactly 0 on both sides.  Then posit_gemm's transpose_a (the dW
        leg) at the five training dW shapes and one posit16 A, within the
        f32 dot-product bound over K = 4,096."""
        torch = self.torch
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import flash_attention as F
        from repro_torch.kernels import posit_gemm as G
        from repro_torch.kernels import ref
        B, H, n_kv, D = 8, 15, 5, 64
        dev = self.dev
        worst = 0.0
        cases = [("train", 512, None, None, None, None, None),
                 ("edge", 128, [0, 16, 100, 384, 200, 300, 7, 50],
                  [128, 144, 228, 512, 328, 420, 135, 100], 64, 30.0, None),
                 ("edge", 128, [0, 16, 100, 384, 200, 300, 7, 50],
                  [128, 144, 228, 512, 328, 420, 135, 100], 64, 30.0, P16_2)]
        for tag, Sq, qo, kl, window, softcap, cfg in cases:
            Skv = 512
            q, do = self.randn(B, H, Sq, D), self.randn(B, H, Sq, D)
            k, v = self.randn(B, n_kv, Skv, D), self.randn(B, n_kv, Skv, D)
            if cfg is not None:
                k, v = ref.encode_ref(k, cfg), ref.encode_ref(v, cfg)
            qo = torch.tensor(qo or [0] * B, dtype=torch.int32, device=dev)
            kl = torch.tensor(kl or [Skv] * B, dtype=torch.int32, device=dev)
            kw = dict(cfg_kv=cfg, causal=True, window=window, softcap=softcap)
            label = (f"{tag} Sq={Sq} Skv={Skv} {cfg or 'f32'} KV window="
                     f"{window} softcap={softcap}")
            o, lse = F.flash_prefill_contiguous(q, k, v, kl, qo,
                                                return_lse=True, **kw)
            po, plse = F.flash_prefill_contiguous_plain(q, k, v, kl, qo,
                                                        return_lse=True, **kw)
            dq, dk, dv = F.flash_prefill_bwd_contiguous(q, k, v, po, plse, do,
                                                        kl, qo, **kw)
            pdq, pdk, pdv = F.flash_prefill_bwd_contiguous_plain(
                q, k, v, po, plse, do, kl, qo, **kw)
            tol = self._attn_bounds(q, k, v, po, plse, do, kl, qo, cfg,
                                    True, window, softcap)
            qpos = qo[:, None] + torch.arange(Sq, device=dev)[None, :]
            lo = torch.clamp(qpos - (window or Skv) + 1, min=0)
            dead = (lo >= torch.minimum(kl[:, None], qpos + 1))[:, None, :]
            dead = dead.expand(B, H, Sq)
            for name, pairs in (
                    ("flash_prefill", (("out", o, po), ("lse", lse, plse))),
                    ("flash_prefill_bwd_dq", (("dq", dq, pdq),)),
                    ("flash_prefill_bwd_dkv", (("dk", dk, pdk),
                                               ("dv", dv, pdv)))):
                for what, got, want in pairs:
                    if got is None:
                        continue
                    worst = max(worst, self._within(
                        name, f"{what} {label}", got, want, tol[what]))
            n_dead = int(dead.sum())
            if n_dead and not all(
                    bool((t[dead] == 0).all())
                    for t in (o, po, lse, plse, dq, pdq)):
                raise AssertionError(f"flash prefill {label}: rows that see "
                                     f"no key are not 0")
            log(f"[train-kernels] {label}: {n_dead} rows see no key, 0 on "
                f"both sides")
            if (pdk is None) != (cfg is not None) or (dk is None) != (
                    cfg is not None):
                raise AssertionError("dK/dV must be None exactly for posit "
                                     "KV")
            del tol
        K = 4096
        for M, N in DW_SHAPES:
            a, g = self.randn(K, M), self.randn(K, N)
            got = G.posit_gemm(a, g, cfg_a=None, cfg_b=None, transpose_a=True)
            want = G.posit_gemm_plain(a, g, cfg_a=None, cfg_b=None,
                                      transpose_a=True)
            tol = 2 * K * 2.0 ** -24 * (a.abs().T @ g.abs())
            worst = max(worst, self._within(
                "posit_gemm_transpose_a", f"f32 A [K={K}, M={M}] N={N}",
                got, want, tol))
            del a, g, got, want, tol
        a = ref.encode_ref(self.randn(K, 960), P16_2)
        g = self.randn(K, 320)
        tol = 2 * K * 2.0 ** -24 * (ref.decode_ref(a, P16_2).abs().T @ g.abs())
        worst = max(worst, self._within(
            "posit_gemm_transpose_a", f"posit16 A [K={K}, M=960] N=320",
            G.posit_gemm(a, g, cfg_a=P16_2, cfg_b=None, transpose_a=True),
            G.posit_gemm_plain(a, g, cfg_a=P16_2, cfg_b=None,
                               transpose_a=True), tol))
        self.details["training_kernels_worst_err_over_bound"] = worst

    def time_training_kernels(self):
        """K7-K9 at one layer of the training step ([8,15,512,64] causal,
        f32 KV) and transpose_a at the step's dW shapes (K = 4,096), each
        beside its plain version, its library call and its bound.  Causal
        work counts the B H S (S + 1) / 2 visible pairs; per pair the
        forward does 4 D flops (q.k and p v), dQ 6 D (q.k, dO.v, ds k) and
        dK/dV 8 D (q.k, dO.v, p dO, ds q)."""
        torch = self.torch
        from repro_torch.kernels import flash_attention as F
        from repro_torch.kernels import posit_gemm as G
        B, H, n_kv, S, D = 8, 15, 5, 512, 64
        dev = self.dev
        pairs = B * H * S * (S + 1) // 2
        q_bytes, kv_bytes, row_bytes = 4 * B * H * S * D, 4 * B * n_kv * S * D, \
            4 * B * H * S
        kl = torch.full((B,), S, dtype=torch.int32, device=dev)
        qo = torch.zeros((B,), dtype=torch.int32, device=dev)
        nset = copies_for(2 * q_bytes + 2 * kv_bytes, 8)
        sets = []
        for _ in range(nset):
            q, do = self.randn(B, H, S, D), self.randn(B, H, S, D)
            k, v = self.randn(B, n_kv, S, D), self.randn(B, n_kv, S, D)
            o, lse = F.flash_prefill_contiguous_plain(q, k, v, kl, qo,
                                                      return_lse=True)
            delta = (do * o).sum(-1)
            sets.append((q, k, v, do, lse, delta))
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def fwd(q, k, v, *_):
            return F.flash_prefill_contiguous(q, k, v, kl, qo,
                                              return_lse=True)

        def fwd_plain(q, k, v, *_):
            return F.flash_prefill_contiguous_plain(q, k, v, kl, qo,
                                                    return_lse=True)

        def lib_fwd(q, k, v, *_):
            return sdpa(q, k, v, is_causal=True, enable_gqa=True)

        def lib_fwd_bwd(q, k, v, do, *_):
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            out = sdpa(q, k, v, is_causal=True, enable_gqa=True)
            return torch.autograd.grad(out, (q, k, v), do)

        def dq(q, k, v, do, lse, delta):
            return F.flash_prefill_bwd_dq(q, k, v, do, lse, delta, kl, qo)

        def dq_plain(q, k, v, do, lse, delta):
            return F.flash_prefill_bwd_dq_plain(q, k, v, do, lse, delta, kl,
                                                qo)

        def dkv(q, k, v, do, lse, delta):
            return F.flash_prefill_bwd_dkv(q, k, v, do, lse, delta, kl, qo)

        def dkv_plain(q, k, v, do, lse, delta):
            return F.flash_prefill_bwd_dkv_plain(q, k, v, do, lse, delta, kl,
                                                 qo)

        it = 20
        lib_f = time_ms(torch, lib_fwd, sets, it, "sdpa forward")
        lib_fb = time_ms(torch, lib_fwd_bwd, sets, it, "sdpa forward+backward")
        lib_b = lib_fb - lib_f
        shape = "one layer of the training step: [8,15,512,64] causal, f32 KV"
        for name, fn, plain, flops, nbytes, lib in (
                ("flash_prefill", fwd, fwd_plain, 4 * D * pairs,
                 2 * q_bytes + 2 * kv_bytes + row_bytes, lib_f),
                ("flash_prefill_bwd_dq", dq, dq_plain, 6 * D * pairs,
                 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes, lib_b),
                ("flash_prefill_bwd_dkv", dkv, dkv_plain, 8 * D * pairs,
                 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes, lib_b)):
            kern = time_ms(torch, fn, sets, it, name)
            pl = time_ms(torch, plain, sets, 3, f"{name} plain")
            b, by = bound(nbytes, flops)
            self.record(name, shape=shape + (
                "; library: SDPA's whole backward (dQ, dK, dV together)"
                if "bwd" in name else "; library: SDPA forward"),
                ms=kern, plain_ms=pl, bound_ms=b, bound_by=by,
                library_ms=lib)
            log(f"[time] {name}: {kern:.4f} ms (plain {pl:.4f}, library "
                f"{lib:.4f}, bound {b:.4f} by {by}) per layer")
        del sets

        total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                 "bytes": 0.0, "flops": 0.0}
        rows = []
        K = 4096
        for (M, N), count in zip(DW_SHAPES, DW_PER_STEP):
            nb = 4 * (K * M + K * N + M * N)
            gsets = [(self.randn(K, M), self.randn(K, N))
                     for _ in range(copies_for(nb, 8))]
            at = f"dW M={M} N={N} K={K}"
            kern = time_ms(torch, lambda a, g: G.posit_gemm(
                a, g, cfg_a=None, cfg_b=None, transpose_a=True), gsets,
                ITERS if M < 10000 else 10, f"transpose_a {at}")
            pl = time_ms(torch, lambda a, g: G.posit_gemm_plain(
                a, g, cfg_a=None, cfg_b=None, transpose_a=True), gsets, 5,
                f"transpose_a plain {at}")
            lib = time_ms(torch, lambda a, g: torch.matmul(a.T, g), gsets,
                          ITERS if M < 10000 else 10, f"torch.matmul {at}")
            flops = 2.0 * M * N * K
            b, by = bound(nb, flops)
            rows.append({"M": M, "N": N, "K": K, "per_step": count,
                         "ms": kern, "plain_ms": pl, "library_ms": lib,
                         "bound_ms": b, "bound_by": by,
                         "tflop_per_s": flops / kern / 1e9})
            log(f"[time] posit_gemm transpose_a {at}: {kern:.4f} ms "
                f"({flops / kern / 1e9:.1f} TFLOP/s; plain {pl:.4f}, "
                f"torch.matmul(a.T, g) f32 {lib:.4f}, bound {b:.4f} by {by})")
            for key, val in (("ms", kern), ("plain_ms", pl),
                             ("library_ms", lib), ("bytes", nb),
                             ("flops", flops)):
                total[key] += count * val
            del gsets
        self.details["transpose_a_shapes"] = rows
        b, by = bound(total["bytes"], total["flops"])
        self.record("posit_gemm_transpose_a",
                    shape="the dW GEMMs of one training step: 225 at K=4096 "
                          "(7 per layer x 32 + the tied table), f32",
                    ms=total["ms"], plain_ms=total["plain_ms"],
                    library_ms=total["library_ms"], bound_ms=b, bound_by=by)

    # ---- phase 2c: the paper's arithmetic (elementwise, divide, quire GEMM)
    def _pairs_p8(self, dt):
        torch = self.torch
        bits = torch.arange(-128, 128, device=self.dev, dtype=torch.int32)
        return (bits.repeat_interleave(256).to(dt), bits.repeat(256).to(dt))

    def _rand_bits(self, n, count):
        torch = self.torch
        return torch.randint(-(1 << (n - 1)), 1 << (n - 1), (count,),
                             generator=self.gen, device=self.dev,
                             dtype=torch.int32).to(
                                 torch.int8 if n == 8 else torch.int16)

    def _same(self, label, got, want):
        bad = int((got != want).sum())
        if bad or got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"[arith] {label}: {bad} of {want.numel()} "
                                 f"patterns differ from the plain version")
        return want.numel()

    def _arith_sets(self, label, cfg, A, B, C, modes):
        """add/sub/mul/fma and every divide (mode, nr) on one operand set,
        kernel against plain version, bit for bit; returns lanes checked."""
        from repro_torch.kernels import posit_elementwise as E
        lanes = 0
        for op in ("add", "sub", "mul", "fma"):
            ins = (A, B, C) if op == "fma" else (A, B)
            lanes += self._same(f"{label} {op}", E.elementwise(op, *ins,
                                                               cfg=cfg),
                                E.elementwise_plain(op, *ins, cfg=cfg))
        for mode, nr in modes:
            lanes += self._same(
                f"{label} divide {mode} nr={nr}",
                E.divide(A, B, cfg=cfg, mode=mode, nr_rounds=nr),
                E.divide_plain(A, B, cfg=cfg, mode=mode, nr_rounds=nr))
        return lanes

    def check_arith(self):
        torch = self.torch
        from repro_torch.core.types import P8_2, PositConfig
        from repro_torch.kernels import ops
        from repro_torch.kernels import posit_elementwise as E
        modes = [(m, nr) for m in DIV_MODES for nr in (0, 1)]
        t0 = time.perf_counter()
        lanes = 0
        for es in range(5):                      # every posit8 pair
            cfg = PositConfig(8, es)
            A, B = self._pairs_p8(torch.int8)
            lanes += self._arith_sets(f"{cfg} every pair", cfg, A, B,
                                      torch.roll(A, 12345), modes)
            one = torch.tensor(cfg.one_bits, dtype=torch.int8,
                               device=self.dev)
            lanes += self._same(f"{cfg} reciprocal", ops.divide(one, B,
                                                                cfg=cfg),
                                E.divide_plain(one.expand(B.shape), B,
                                               cfg=cfg))
        A, B = self._pairs_p8(torch.int8)        # every P8_2 fma triple
        A3, B3 = A.repeat(256), B.repeat(256)
        C3 = torch.arange(-128, 128, device=self.dev, dtype=torch.int32
                          ).repeat_interleave(65536).to(torch.int8)
        lanes += self._same("posit8es2 every fma triple",
                            E.elementwise("fma", A3, B3, C3, cfg=P8_2),
                            E.elementwise_plain("fma", A3, B3, C3, cfg=P8_2))
        del A3, B3, C3
        for es in (1, 2):                        # posit16 samples + edges
            cfg = PositConfig(16, es)
            A, B, C = (self._rand_bits(16, ARITH_LANES) for _ in range(3))
            lanes += self._arith_sets(f"{cfg} 2^26 seeded", cfg, A, B, C,
                                      modes)
            del A, B, C
            m = cfg.mask
            edge = torch.tensor([0, cfg.nar, cfg.one_bits, -cfg.one_bits & m,
                                 1, m, cfg.maxpos_bits, -cfg.maxpos_bits & m],
                                device=self.dev, dtype=torch.int32)
            allp = torch.arange(1 << 16, device=self.dev, dtype=torch.int32)
            A = torch.cat([edge.repeat_interleave(allp.numel()),
                           allp.repeat(edge.numel())])
            B = torch.cat([allp.repeat(edge.numel()),
                           edge.repeat_interleave(allp.numel())])
            A, B = (x.to(torch.int16) for x in (A, B))
            # fma's c: A rolled by 4099 lanes (edges as c beside edge a)
            lanes += self._arith_sets(f"{cfg} edges x all patterns", cfg, A,
                                      B, torch.roll(A, 4099), modes)
        self.err("elementwise", 0.0)
        self.err("divide", 0.0)
        self.details["arith_lanes_checked"] = lanes
        log(f"[arith] kernels vs plain versions bit-exact on {lanes} lanes: "
            f"p8 es 0..4 every pair (add, sub, mul, fma, 4 divide modes x "
            f"nr 0/1, reciprocal), every posit8es2 fma triple, p16 es 1/2 "
            f"2^26 seeded pairs/triples and edges x all patterns "
            f"({time.perf_counter() - t0:.1f} s)")

    def table2(self):
        """Paper Table II on the card: wrong-% of the approximate dividers
        (poly NR 1; pacogen NR 0 for p8, 1 for p16) against the exact one,
        on the protocol of benchmarks/division_accuracy.py (every pair for
        posit8, 10^6 pairs from np.random.default_rng(0) for posit16);
        poly_corrected must be exact."""
        torch = self.torch
        import numpy as np
        from repro_torch.core.types import table2_grid
        from repro_torch.kernels import posit_elementwise as E
        rows = []
        for cfg in table2_grid():
            if cfg.n == 8:
                bits = np.arange(256)
                A, B = np.meshgrid(bits, bits)
                A, B = A.ravel(), B.ravel()
            else:
                rng = np.random.default_rng(0)
                A = rng.integers(0, 1 << cfg.n, 1_000_000)
                B = rng.integers(0, 1 << cfg.n, 1_000_000)
            dt = getattr(torch, cfg.storage_dtype_name)
            A, B = (torch.from_numpy(x.astype(np.int32)).to(self.dev).to(dt)
                    for x in (A, B))
            exact = E.divide(A, B, cfg=cfg, mode="exact")
            row = {"N": cfg.n, "ES": cfg.es, "pairs": A.numel()}
            for key, mode, nr in (("poly", "poly", 1),
                                  ("pacogen", "pacogen", PACOGEN_NR[cfg.n]),
                                  ("poly_corrected", "poly_corrected", 1)):
                got = E.divide(A, B, cfg=cfg, mode=mode, nr_rounds=nr)
                row[f"{key}_wrong_pct"] = 100.0 * float(
                    (got != exact).double().mean())
                row[f"{key}_NR"] = nr
            rows.append(row)
            log(f"[table2] {cfg}: {row['pairs']} pairs, wrong % vs exact: "
                f"poly (NR 1) {row['poly_wrong_pct']!r}, pacogen (NR "
                f"{row['pacogen_NR']}) {row['pacogen_wrong_pct']!r}, "
                f"poly_corrected {row['poly_corrected_wrong_pct']!r}")
            if row["poly_corrected_wrong_pct"] != 0.0:
                raise AssertionError(f"Table II {cfg}: poly_corrected is not "
                                     f"correctly rounded")
        self.details["table2"] = rows

    def _posit_within(self, label, pos, acc_ref, tol, cfg):
        """pos must lie between the roundings of acc_ref - tol and
        acc_ref + tol (posit patterns are monotone as signed ints): what an
        accumulator within `tol` of acc_ref, rounded once, can give.
        Returns (equal, one pattern apart, further apart) counts against
        the rounding of acc_ref itself."""
        from repro_torch.kernels import ref
        lo = ref.encode_ref(acc_ref - tol, cfg).int()
        hi = ref.encode_ref(acc_ref + tol, cfg).int()
        p = pos.int()
        if not bool(((lo <= p) & (p <= hi)).all()):
            raise AssertionError(f"{label}: posit out outside the rounding "
                                 f"of the f32 bound around the plain sum")
        d = (p - ref.encode_ref(acc_ref, cfg).int()).abs()
        return (int((d == 0).sum()), int((d == 1).sum()),
                int((d > 1).sum()))

    def check_quire_gemm(self):
        """The quire GEMM (posit16 A and B) at M = 1024 against smollm-360m's
        layer shapes: the f32 accumulator within the f32 dot-product bound
        of the plain version; posit out the single rounding of the kernel's
        own accumulator, so it differs from the plain version's only where
        the two accumulators straddle a rounding boundary (counted, and
        held within the rounding of the bound)."""
        torch = self.torch
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import posit_gemm as G
        from repro_torch.kernels import ref
        cfg, worst, counts = P16_2, 0.0, [0, 0, 0]
        for K, N, tb in QUIRE_SHAPES + [(960, 2560, True)]:
            a = ref.encode_ref(self.randn(1024, K), cfg)
            b = ref.encode_ref(self.randn(*((N, K) if tb else (K, N)),
                                          scale=K ** -0.5), cfg)
            kw = dict(cfg_a=cfg, cfg_b=cfg, transpose_b=tb)
            acc = G.posit_gemm(a, b, **kw)
            want = G.posit_gemm_plain(a, b, **kw)
            af, bf = ref.decode_ref(a, cfg), ref.decode_ref(b, cfg)
            tol = 2 * K * 2.0 ** -24 * (af.abs() @ (bf.T if tb else bf).abs())
            diff = (acc - want).abs()
            worst = max(worst, float((diff / (tol + 1e-30)).max()))
            self.err("posit_gemm", diff.max())
            pos = G.posit_gemm(a, b, cfg_out=cfg, out_posit=True, **kw)
            pos_plain = G.posit_gemm_plain(a, b, cfg_out=cfg, out_posit=True,
                                           **kw)
            # the epilogue rounds the kernel's own accumulator exactly once
            self._same(f"quire GEMM K={K} N={N} epilogue",
                       pos, ref.encode_ref(acc, cfg))
            self._same(f"quire GEMM K={K} N={N} plain epilogue", pos_plain,
                       ref.encode_ref(want, cfg))
            c3 = self._posit_within(f"quire GEMM K={K} N={N}", pos, want,
                                    tol, cfg)
            counts = [x + y for x, y in zip(counts, c3)]
            log(f"[quire] {cfg} M=1024 K={K} N={N} transpose_b={tb}: f32 "
                f"max|err| {float(diff.max()):.3e}; posit out vs plain: "
                f"{c3[0]} equal, {c3[1]} one pattern apart, {c3[2]} further "
                f"(accumulators straddling rounding boundaries)")
        if worst > 1.0:
            raise AssertionError("quire GEMM: f32 accumulator outside the "
                                 "f32 dot-product bound")
        self.details["quire_gemm"] = {"worst_err_over_bound": worst,
                                      "equal": counts[0],
                                      "one_pattern_apart": counts[1],
                                      "further_apart": counts[2]}
        log(f"[quire] worst err/bound {worst:.3e}; posit outputs vs plain: "
            f"{counts[0]} equal, {counts[1]} one pattern apart, {counts[2]} "
            f"further, all within the rounding of the f32 bound")

    def time_arith(self):
        """Each arithmetic kernel at its main path's size: elementwise and
        divide over 2^26 posit16 lanes, the quire GEMM at M = 1024 on
        smollm-360m's shapes; beside the plain version, the library call
        where one exists, and the bound."""
        torch = self.torch
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import build
        from repro_torch.kernels import posit_elementwise as E
        from repro_torch.kernels import posit_gemm as G
        from repro_torch.kernels import ref
        cfg, lanes = P16_2, ARITH_LANES
        clock_mhz = gpu_max_sm_clock_mhz()
        issue = 132 * 128 * clock_mhz * 1e6      # thread-instructions / s
        lib = str(build.library_path("posit_elementwise"))
        sets = [tuple(self._rand_bits(16, lanes) for _ in range(3))
                for _ in range(2)]               # 2 x 384 MB: L2 stays cold
        rows = {}

        def row(name, kind, fn, plain, n_in, sass):
            # bound: HBM bytes (n_in operands read, one written); the SASS
            # count beside it is a diagnostic of the kernel's own code
            ipl, how = sass_per_lane(lib, sass, 8)
            tb = (n_in + 1) * 2 * lanes / HBM_BYTES_PER_S * 1e3
            ti = lanes * ipl / issue * 1e3
            kern = time_ms(torch, fn, [s[:n_in] for s in sets], ITERS, name)
            pl = time_ms(torch, plain, [s[:n_in] for s in sets], 3,
                         f"{name} plain")
            rows[name] = {
                "kind": kind, "ms": kern, "plain_ms": pl, "bound_ms": tb,
                "bound_by": "bytes", "library_ms": None,
                "sass_instr_per_lane": ipl, "sass_issue_ms": ti,
                "sass_method": how}
            log(f"[time] {name} 2^26 p16 lanes: {kern:.4f} ms (plain "
                f"{pl:.2f}; bound {tb:.4f} by bytes; no library call; "
                f"diagnostic: {how} = {ipl:.1f} per lane, issued at "
                f"{clock_mhz} MHz x 132 SMs x 128 lanes in {ti:.4f} ms)")

        for op, code in (("add", 0), ("sub", 1), ("mul", 2), ("fma", 3)):
            n_in = 3 if op == "fma" else 2
            row(f"elementwise {op}", "elementwise",
                lambda *a, op=op: E.elementwise(op, *a, cfg=cfg),
                lambda *a, op=op: E.elementwise_plain(op, *a, cfg=cfg),
                n_in, f"ew_kernelILi{code}EsE")
        for i, mode in enumerate(DIV_MODES):
            row(f"divide {mode} nr=1", "divide",
                lambda a, b, mode=mode: E.divide(a, b, cfg=cfg, mode=mode),
                lambda a, b, mode=mode: E.divide_plain(a, b, cfg=cfg,
                                                       mode=mode),
                2, f"div_kernelILi{i}EsE")
        del sets
        self.details["arith_timings"] = rows
        for name, key in (("elementwise", "elementwise add"),
                          ("divide", "divide poly_corrected nr=1")):
            r = rows[key]
            self.record(name, shape=f"{key}, 2^26 posit16 lanes, cold",
                        **{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")})

        # the quire GEMM: posit16 A and B -> posit16, M = 1024
        total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                 "bytes": 0.0, "flops": 0.0}
        grows = []
        for K, N, _ in QUIRE_SHAPES:
            bsets = [ref.encode_ref(self.randn(K, N, scale=K ** -0.5), cfg)
                     for _ in range(copies_for(2 * K * N, 8))]
            a = ref.encode_ref(self.randn(1024, K), cfg)
            af = ref.decode_ref(a, cfg)
            bfs = [ref.decode_ref(b, cfg) for b in bsets[:4]]
            kw = dict(cfg_a=cfg, cfg_b=cfg, cfg_out=cfg, out_posit=True)
            at = f"quire GEMM K={K} N={N}"
            kern = time_ms(torch, lambda b: G.posit_gemm(a, b, **kw),
                           [(b,) for b in bsets], ITERS, at)
            pl = time_ms(torch, lambda b: G.posit_gemm_plain(a, b, **kw),
                         [(b,) for b in bsets], 10, f"{at} plain")
            libm = time_ms(torch, lambda bf: torch.matmul(af, bf),
                           [(bf,) for bf in bfs], ITERS, f"{at} torch.matmul")
            nbytes = 2 * 1024 * K + 2 * K * N + 2 * 1024 * N
            b_ms, by = bound(nbytes, 2.0 * 1024 * K * N)
            grows.append({"M": 1024, "K": K, "N": N, "ms": kern,
                          "plain_ms": pl, "library_ms": libm,
                          "bound_ms": b_ms, "bound_by": by})
            log(f"[time] posit_gemm p16 x p16 -> p16 M=1024 K={K} N={N}: "
                f"{kern:.4f} ms (plain {pl:.4f}, torch.matmul on decoded f32 "
                f"{libm:.4f}, bound {b_ms:.4f} by {by})")
            for k, v in (("ms", kern), ("plain_ms", pl), ("library_ms", libm),
                         ("bytes", nbytes), ("flops", 2.0 * 1024 * K * N)):
                total[k] += v
        self.details["quire_gemm_timings"] = grows
        b_ms, by = bound(total["bytes"], total["flops"])
        self.record("posit_gemm", shape="quire GEMM p16 x p16 -> p16, M=1024, "
                    "sum of 960x960 + 960x2560 + 2560x960",
                    ms=total["ms"], plain_ms=total["plain_ms"],
                    library_ms=total["library_ms"], bound_ms=b_ms,
                    bound_by=by)
        self.details["gpu_max_sm_clock_mhz"] = clock_mhz

    def arithmetic(self):
        """The arithmetic main path through the first-class API: pnp arrays of
        2^26 posit16 lanes through +, -, *, fma, / (every mode) and the
        reciprocal, and the quire GEMM on smollm-360m's shapes, with every
        launch counter zeroed just before and read just after; then its
        encodes against the plain encode on the card, and its outputs
        against the plain versions on the CPU."""
        torch = self.torch
        import repro_torch.pnp as pnp
        from repro_torch.core import ops as cops
        from repro_torch.core.quire import quire_matmul
        from repro_torch.kernels import ops
        from repro_torch.kernels import posit_codec as C
        cfg = pnp.P16_2
        x, y, z = (self.randn(ARITH_LANES) for _ in range(3))
        mats = [self.randn(1024, 960)] + [self.randn(K, N, scale=K ** -0.5)
                                          for K, N, _ in QUIRE_SHAPES]
        torch.cuda.synchronize()

        # ---- the counted run ----
        ops.reset_counters()
        t0 = time.perf_counter()
        a, b, c = (pnp.asarray(v, cfg) for v in (x, y, z))
        out = {"add": a + b, "sub": a - b, "mul": a * b,
               "fma": pnp.fma(a, b, c), "div": a / b,
               "recip": pnp.reciprocal(b)}
        for mode in DIV_MODES:
            out[mode] = pnp.divide(a, b, mode=mode)
        A = pnp.asarray(mats[0], cfg)
        Ws = [pnp.asarray(w, cfg) for w in mats[1:]]
        h1 = A @ Ws[0]                           # 1024x960 @ 960x960
        h2 = A @ Ws[1]                           # @ 960x2560
        h3 = h2 @ Ws[2]                          # 1024x2560 @ 2560x960
        acc = pnp.matmul(A, Ws[0], out_posit=False)
        lt = a < b
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        plain = ops.plain_counts()
        # ---- end of the counted run ----

        expect = {"elementwise": 4, "divide": 6, "posit_gemm": 4}
        if any(plain.values()):
            raise AssertionError(f"plain versions ran on the arithmetic "
                                 f"path: {plain}")
        if {k: launches[k] for k in expect} != expect:
            raise AssertionError(f"arithmetic launch counts {launches} "
                                 f"differ from the path's {expect}")
        # every encode of the counted run (pnp.asarray) against the plain
        # encode of the same values, in full on the card
        for label, arr, v in (("a", a, x), ("b", b, y), ("c", c, z),
                              ("A", A, mats[0]),
                              *((f"W{i}", W, m) for i, (W, m) in
                                enumerate(zip(Ws, mats[1:])))):
            self._same(f"pnp.asarray {label} {tuple(v.shape)}", arr.bits,
                       C.encode_block_plain(v, cfg))
        n = 1 << 16                              # checked on the CPU
        cpu = {k: v.bits[:n].cpu() for k, v in (("a", a), ("b", b),
                                                 ("c", c))}
        want = {"add": cops.padd(cpu["a"], cpu["b"], cfg),
                "sub": cops.psub(cpu["a"], cpu["b"], cfg),
                "mul": cops.pmul(cpu["a"], cpu["b"], cfg),
                "fma": cops.pfma(cpu["a"], cpu["b"], cpu["c"], cfg),
                "div": cops.pdiv(cpu["a"], cpu["b"], cfg),
                "recip": cops.precip(cpu["b"], cfg)}
        for mode in DIV_MODES:
            want[mode] = cops.pdiv(cpu["a"], cpu["b"], cfg, mode=mode)
        nar = cfg.nar - (1 << cfg.n)             # NaR, sign-extended
        b_zero = b.bits == 0                     # x/0 = NaR, and only that
        for k, w in want.items():
            self._same(f"pnp {k} vs the CPU", out[k].bits[:n].cpu(), w)
            want_nar = (b_zero if k in DIV_MODES + ("div", "recip")
                        else torch.zeros_like(b_zero))
            if not torch.equal(out[k].bits == nar, want_nar):
                raise AssertionError(f"pnp {k}: NaR where the operands give "
                                     f"none, or none where they do")
        if not torch.equal(lt[:n].cpu(), cops.plt(cpu["a"], cpu["b"], cfg)):
            raise AssertionError("pnp a < b disagrees with the CPU")
        for X, W, Y in ((A, Ws[0], h1), (A, Ws[1], h2), (h2, Ws[2], h3)):
            xf, wf = X[:8].to("cpu").to_f32(), W.to("cpu").to_f32()
            ref_acc = quire_matmul(X.bits[:8].cpu(), W.bits.cpu(), cfg,
                                   out_posit=False)
            tol = 2 * xf.shape[1] * 2.0 ** -24 * (xf.abs() @ wf.abs())
            if tuple(Y.shape) != (1024, W.shape[1]):
                raise AssertionError("pnp matmul: wrong output shape")
            self._posit_within("pnp matmul vs the CPU", Y.bits[:8].cpu(),
                               ref_acc, tol, cfg)
            if Y is h1 and not (
                    bool(torch.isfinite(acc).all())
                    and bool(((acc[:8].cpu() - ref_acc).abs() <= tol).all())):
                raise AssertionError("pnp matmul f32 accumulator disagrees")
        for name in expect:
            self.record(name, launches=launches[name])
        self.details["arithmetic"] = {"launches": launches, "wall_s": wall,
                                      "lanes": ARITH_LANES,
                                      "zero_divisors": int(b_zero.sum())}
        log(f"[arith] pnp main path on {self.details['gpu']}: 2^26 posit16 "
            f"lanes through + - * fma / (4 modes) reciprocal <, and the "
            f"quire GEMM chain 1024x960 @ 960x960, @ 960x2560, @ 2560x960: "
            f"{wall:.3f} s wall; launches {json.dumps(launches)}; "
            f"{int(b_zero.sum())} zero divisors give NaR; its "
            f"{launches['encode_block']} encodes equal the plain encode in "
            f"full; outputs equal to the plain versions on the CPU (first "
            f"2^16 lanes; GEMM rows 0-7 within the rounding of the f32 "
            f"bound)")
        return {k: launches[k] for k in expect}

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
        missing = [k for k in SERVING_KERNELS if launches[k] == 0]
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
        launches = {k: launches[k] for k in SERVING_KERNELS}
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
        by_name = device_time_by_kernel(torch, prof)
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
                     k: v[0] / steps / 1e3 for k, v in top}}
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

    # ---- phase 5: the training path ----------------------------------------
    def train_whole_step(self):
        """(a) One step's loss and gradients of smollm-360m at full width,
        depth 2, posit16 STE weights, from the same seeded init on the same
        batch (2 x 256 tokens, to keep the CPU side short): the kernels on the card against the plain
        versions on the CPU, within TRAIN_LOSS_RTOL and TRAIN_GRAD_TOL."""
        torch = self.torch
        from repro_torch import configs, tree
        from repro_torch.core.types import P16_2
        from repro_torch.data.pipeline import DataConfig, global_batch_at
        from repro_torch.kernels import ops
        from repro_torch.models.transformer import init_params
        from repro_torch.quant.policy import PositPolicy
        from repro_torch.training.train_step import _compute_grads
        cfg = dataclasses.replace(configs.get_config(
            "smollm-360m", policy=PositPolicy(weights=P16_2)), n_layers=2)
        params = init_params(cfg, seed=0, device="cpu")
        batch = global_batch_at(0, DataConfig(vocab=cfg.vocab, seq_len=256,
                                              global_batch=2), device="cpu")
        gparams, gbatch = self._to(params, self.dev), self._to(batch, self.dev)
        ops.reset_counters()
        loss_g, _, grads_g = _compute_grads(gparams, gbatch, cfg, 1)
        torch.cuda.synchronize()
        if any(ops.plain_counts().values()):
            raise AssertionError(f"plain versions ran on the card: "
                                 f"{ops.plain_counts()}")
        t0 = time.perf_counter()
        loss_c, _, grads_c = _compute_grads(params, batch, cfg, 1)
        cpu_s = time.perf_counter() - t0
        rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
        worst = 0.0
        for a, b in zip(tree.leaves(grads_g), tree.leaves(grads_c)):
            a = a.cpu()
            if not bool(torch.isfinite(a).all()):
                raise AssertionError("non-finite gradient on the card")
            worst = max(worst, float((a - b).abs().max() / b.abs().max()))
        self.details["train_whole_step"] = {
            "loss_card": float(loss_g), "loss_cpu": float(loss_c),
            "loss_rel_err": rel, "grad_worst_err_over_max": worst,
            "cpu_s": cpu_s}
        log(f"[train] depth-2 full-width p16 step, card (kernels) vs CPU "
            f"(plain, {cpu_s:.1f} s): loss {float(loss_g):.6f} vs "
            f"{float(loss_c):.6f}, rel err {rel:.3e} (tol "
            f"{TRAIN_LOSS_RTOL}); worst gradient leaf max|diff|/max|g| "
            f"{worst:.3e} (tol {TRAIN_GRAD_TOL})")
        if not (rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_TOL):
            raise AssertionError("training step: card and CPU disagree")

    def _train_leg(self, cfg, steps, data, opt):
        """train_loop from seed 0 with every counter zeroed just before
        and read just after; returns (params, history, launches, plain,
        peak bytes, wall s)."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.training.trainer import train_loop
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_counters()
        t0 = time.perf_counter()
        params, _, hist = train_loop(cfg, opt, data, steps, log_every=1,
                                     verbose=False, device=self.dev, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (params, hist, ops.launch_counts(), ops.plain_counts(),
                torch.cuda.max_memory_allocated(), wall)

    def train_full(self):
        """(b) The training main path: `train_loop` on full-width
        smollm-360m (32 layers, nothing cut), 8 steps of 8 x 512 tokens
        with posit16 STE weights and 8 with PositPolicy(), same init and
        batches (the port's run of the p16-vs-f32 loss-gap experiment);
        after the p16 leg, one more p16 step under torch.profiler for the
        busy share."""
        import numpy as np
        from repro_torch import configs
        from repro_torch.core.types import P16_2
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.optim.adamw import OptConfig
        from repro_torch.quant.policy import PositPolicy
        steps = TRAIN_STEPS
        # launch/train.py's settings for --steps 8
        opt = OptConfig(lr_peak=3e-4, warmup_steps=min(100, steps // 10 + 1),
                        total_steps=steps)
        legs = {}
        for name, pol in (("p16", PositPolicy(weights=P16_2)),
                          ("f32", PositPolicy())):
            cfg = configs.get_config("smollm-360m", policy=pol)
            data = DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=8)
            params, hist, launches, plain, peak, wall = self._train_leg(
                cfg, steps, data, opt)
            losses = [h["loss"] for h in hist]
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"{name}: non-finite loss {losses}")
            if any(plain.values()):
                raise AssertionError(f"{name}: plain versions ran on the "
                                     f"training path: {plain}")
            L = cfg.n_layers
            casts = (14 * L + 3) if name == "p16" else 0
            expect = {"posit_gemm": 4 * (7 * L + 1) * steps,
                      "posit_gemm_transpose_a": (7 * L + 1) * steps,
                      "flash_prefill": 2 * L * steps,
                      "flash_prefill_bwd_dq": L * steps,
                      "flash_prefill_bwd_dkv": L * steps,
                      "encode_block": casts * steps,
                      "decode_block": casts * steps}
            got = {k: launches[k] for k in expect}
            if got != expect:
                raise AssertionError(f"{name}: launch counts {launches} "
                                     f"differ from the path's {expect}")
            if any(v for k, v in launches.items() if k not in expect):
                raise AssertionError(f"{name}: kernels off the training "
                                     f"path launched: {launches}")
            step_s = [1.0 / h["steps_per_s"] for h in hist]
            p50 = float(np.percentile(step_s[1:], 50))
            tokens = data.global_batch * data.seq_len
            legs[name] = {
                "losses": losses, "step_s": step_s, "step_p50_s": p50,
                "tokens_per_s": tokens / p50, "peak_bytes": peak,
                "wall_s": wall, "launches": got,
                "launches_per_step": {k: v // steps for k, v in got.items()},
                "plain_calls": plain, "params": cfg.param_count()}
            log(f"[train] {name} leg, smollm-360m full width "
                f"({cfg.param_count()} params), 8 x 512 tokens/step: losses "
                f"{[round(x, 4) for x in losses]}; step p50 {p50:.3f} s "
                f"({tokens / p50:.0f} tok/s; first step {step_s[0]:.3f} s); "
                f"peak {peak / 2 ** 30:.2f} GiB; {wall:.1f} s wall "
                f"({self.details['gpu']})")
            log(f"[train] {name} launches per step "
                f"{json.dumps(legs[name]['launches_per_step'])}; plain "
                f"calls {json.dumps(plain)}")
            if name == "p16":
                # before the f32 leg, so that its peak holds no p16 params
                legs[name]["trace"] = self._profile_step(cfg, params, opt,
                                                         data, p50)
            del params
        gap = [a - b for a, b in zip(legs["p16"]["losses"],
                                     legs["f32"]["losses"])]
        log(f"[train] p16 - f32 loss gap per step: "
            f"{[round(x, 5) for x in gap]}")
        self.details["training"] = dict(legs, gap=gap)
        return legs

    def _profile_step(self, cfg, params, opt, data, step_p50_s):
        """One more training step (fresh AdamW state, outside the counted
        runs, after one unprofiled warm step) under torch.profiler: device
        time by kernel and the busy share, over the profiled step's own
        wall time (a lower bound: the profiler adds host cost) and over the
        unprofiled leg's step p50."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.data.pipeline import global_batch_at
        from repro_torch.optim.adamw import init_state
        from repro_torch.training.train_step import make_train_step
        step_fn = make_train_step(cfg, opt, device=self.dev)
        state = init_state(params, opt)
        batch = global_batch_at(TRAIN_STEPS, data, device=self.dev)
        params, state, _ = step_fn(params, state, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        del params, state
        by_name = device_time_by_kernel(torch, prof)
        busy = sum(v[0] for v in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        trace = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                 "device_busy_share": busy / wall_us if busy else None,
                 "device_busy_share_unprofiled":
                     busy / 1e6 / step_p50_s if busy else None,
                 "device_kernels": sum(v[1] for v in by_name.values()),
                 "top_kernels_ms": {k: v[0] / 1e3 for k, v in top}}
        if not busy:
            log("[train] the profiler saw no device time: busy share not "
                "measured")
            return trace
        log(f"[train] one p16 step under torch.profiler: wall "
            f"{trace['wall_ms']:.1f} ms, device busy "
            f"{trace['device_busy_ms']:.1f} ms (share "
            f"{trace['device_busy_share']:.3f}; of the unprofiled step "
            f"p50: {trace['device_busy_share_unprofiled']:.3f}), "
            f"{trace['device_kernels']} device kernels "
            f"({self.details['gpu']})")
        for k, v in trace["top_kernels_ms"].items():
            log(f"[train]   {v:9.3f} ms  {k}")
        return trace

    def train_resume(self, root):
        """(c) At full width and depth 2 (posit16 STE): 4 steps, a
        checkpoint, a resume for 4 more must end bit for bit where 8
        uninterrupted steps do, params and optimizer state."""
        import shutil
        torch = self.torch
        from repro_torch import configs, tree
        from repro_torch.core.types import P16_2
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.optim.adamw import OptConfig
        from repro_torch.quant.policy import PositPolicy
        from repro_torch.training.trainer import train_loop
        cfg = dataclasses.replace(configs.get_config(
            "smollm-360m", policy=PositPolicy(weights=P16_2)), n_layers=2)
        data = DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=8)
        opt = OptConfig(lr_peak=3e-4, warmup_steps=1, total_steps=8)
        ckpt = os.path.join(root, "build", "chip_smoke_ckpt")
        shutil.rmtree(ckpt, ignore_errors=True)
        kw = dict(verbose=False, device=self.dev, seed=0, log_every=1)
        t0 = time.perf_counter()
        p_full, o_full, _ = train_loop(cfg, opt, data, 8, **kw)
        train_loop(cfg, opt, data, 4, ckpt_dir=ckpt, **kw)
        p_res, o_res, hist = train_loop(cfg, opt, data, 8, ckpt_dir=ckpt,
                                        **kw)
        torch.cuda.synchronize()
        shutil.rmtree(ckpt, ignore_errors=True)
        same = [torch.equal(a, b) for a, b in zip(
            tree.leaves((p_full, o_full)), tree.leaves((p_res, o_res)))]
        self.details["train_resume"] = {
            "leaves": len(same), "bit_identical": all(same),
            "resumed_steps": [h["step"] for h in hist],
            "wall_s": time.perf_counter() - t0}
        log(f"[train] resume at depth 2: 4 steps + checkpoint + 4 resumed "
            f"steps vs 8 uninterrupted: {sum(same)} of {len(same)} leaves "
            f"(params and AdamW state) bit-identical")
        if not all(same) or [h["step"] for h in hist][0] != 4:
            raise AssertionError("resume is not bit-identical to the "
                                 "uninterrupted run")

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
# (K, N, transpose_b) of the quire GEMM at smollm-360m's layer shapes
QUIRE_SHAPES = [(960, 960, False), (960, 2560, False), (2560, 960, False)]
# (M, N) of the training step's dW GEMMs (transpose_a, K = 8 x 512 tokens),
# and how many of each one step runs: wq/wo, wk/wv, w_up/w_gate, w_down
# per layer, the tied table once
DW_SHAPES = [(960, 960), (960, 320), (960, 2560), (2560, 960), (49152, 960)]
DW_PER_STEP = [64, 64, 64, 32, 1]
TRAINING_KERNELS = ("flash_prefill", "flash_prefill_bwd_dq",
                    "flash_prefill_bwd_dkv", "posit_gemm_transpose_a")
SERVING_KERNELS = ("decode_block", "encode_block", "paged_append", "pw_gemm",
                   "paged_flash_decode", "paged_flash_prefill")

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
    "elementwise": ("src/repro_torch/csrc/posit_elementwise.cu",
                    "src/repro/kernels/posit_elementwise.py:50"),
    "divide": ("src/repro_torch/csrc/posit_elementwise.cu",
               "src/repro/kernels/posit_elementwise.py:110"),
    "posit_gemm": ("src/repro_torch/csrc/posit_gemm.cu",
                   "src/repro/kernels/posit_gemm.py:87"),
    "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_attention.py:332"),
    "flash_prefill_bwd_dq": ("src/repro_torch/csrc/flash_prefill.cu",
                             "src/repro/kernels/flash_attention.py:598"),
    "flash_prefill_bwd_dkv": ("src/repro_torch/csrc/flash_prefill.cu",
                              "src/repro/kernels/flash_attention.py:626"),
    "posit_gemm_transpose_a": ("src/repro_torch/csrc/posit_gemm.cu",
                               "src/repro/kernels/posit_gemm.py:87"),
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
    s.check_training_kernels()
    torch.cuda.empty_cache()
    s.time_training_kernels()
    torch.cuda.empty_cache()
    log(f"[phase] training kernels {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s.check_arith()
    s.table2()
    s.check_quire_gemm()
    s.time_arith()
    arith_launches = s.arithmetic()
    torch.cuda.empty_cache()
    log(f"[phase] arithmetic {time.perf_counter() - t0:.1f} s")
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
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    s.train_whole_step()
    log(f"[phase] training step check {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    legs = s.train_full()
    train_launches = {k: legs["p16"]["launches"][k]
                      for k in TRAINING_KERNELS}
    for name, n in train_launches.items():
        s.record(name, launches=n)
    log(f"[phase] training main path {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s.train_resume(root)
    log(f"[phase] training resume {time.perf_counter() - t0:.1f} s")

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
    # the main paths' own counts: the serving kernels read right after the
    # counted drain, the arithmetic kernels right after the counted pnp run,
    # the training kernels right after the counted 8-step p16 run
    log("kernels: " + json.dumps({**s.details["serving"]["launches"],
                                  **arith_launches, **train_launches}))
    log("kernels (training main path, 8 p16 steps): "
        + json.dumps(legs["p16"]["launches"]))
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
