#!/usr/bin/env python3
"""Bring-up check of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--out FILE]
    python3 chip_smoke.py --rwkv-layers [--src DIR]
    python3 chip_smoke.py --skinny-times [--src DIR]
    python3 chip_smoke.py --grouped-times [--src DIR]
    python3 chip_smoke.py --paged-times [--src DIR]
    python3 chip_smoke.py --scan-times [--src DIR]
    python3 chip_smoke.py --codec-times [--src DIR]
    python3 chip_smoke.py --prefill-traces [--src DIR]
    python3 chip_smoke.py --flash-sass DIR

Phases, in order; any failure exits non-zero and prints no result:

1. the card's name and power limit, then the build of every CUDA kernel
   from ``src/repro_torch/csrc`` (one nvcc per source, all in parallel),
   and ptxas's registers of every instance of the tiled posit GEMM and its
   split-K reduce, of the grouped GEMM's decode and tiled forms and its dW
   (K10, K11) and of the flash kernels (K7, K8, K9), none of which may
   spill, nor may the codec (K1), the paged decode (K3), K7's paged
   instance (K4) or the scans (K12, K13);
2. every kernel against its plain PyTorch version on the card, at the
   shapes of full-width smollm-360m, for posit16, posit8 and float pages:
   the codec bit-exact (K1: the decode over every pattern; the encode and
   the one-pass round trip over all 2^32 f32 patterns for P16_2 and P8_2,
   compiled for their format, and P16_1 at run time; every entry on
   ragged lengths and misaligned views, and through its C entry with a
   head of lanes before its float4 steps; the append with masked tokens,
   positions past the table and pages outside the pool at the prefill and
   decode steps' shapes, head_dim 20, 256 and 18, misaligned k and v), the
   posit GEMM within the f32 dot-product error bound (plus, for f32 x f32,
   the 2^-22 (|a| @ |b|) its tensor-core route declares), also at edge
   shapes (M 9/24/129, N 100, K 1/7/33, and two split-K shapes) with f32,
   posit8 and posit16 operands in every transpose_a/transpose_b
   combination, posit out the one rounding of its own f32 result, every
   tiled launch repeated bit-identical; K2's skinny form (M <= 8): the
   decode of every posit16 and posit8 pattern bit-exact through K = 1
   GEMMs (P16_2, P16_1, P8_2, P8_0; both orientations, M 1 and 8), M
   1/3/8 x N 1/100/1,000 x K 1/7/33/4,096 and every served decode shape
   of the four models at M = 8 within the f32 bound, every launch
   repeated bit-identical, and the instructions per weight element of
   its P16_2 main loop from the SASS; the paged attention (K3, K4) within
   1e-4, every launch repeated bit-identical, also at the smoke
   configs' head_dim 20, and both dropping a visible page whose table
   entry lies outside the pool (K4 at Sq = 1, with and without a
   softcap);
   each kernel also timed beside its plain version, one PyTorch library
   call where one exists, and the card's bound (K2's skinny form also at
   every M = 8 decode shape of rwkv6-3b and recurrentgemma-9b, summed
   per decode step);
2d. the training kernels against their plain versions on the card: the
   contiguous flash prefill with its log-sum-exp (K7), the backward's dQ
   (K8) and dK/dV (K9) passes at four head layouts (smollm's G = 3, D =
   64; olmoe's G = 1, D = 128; recurrentgemma's G = 16, D = 256;
   hubert-xlarge's bidirectional D = 80), each at a training shape (8 x
   512 queries over 512 keys) and an edge shape (128 queries over 512
   keys, per-batch q_offset and kv_len, window 64, softcap 30, f32 and
   posit16 KV), rows that see no key exactly 0, the forward, K8 and K9
   repeated bit-identical; posit_gemm's transpose_a (the dW leg) at the
   step's five dW shapes (split-K at four) and one posit16 A, each within
   the bound of phase 2 and repeated bit-identical; their timings beside
   the plain versions, torch.matmul and SDPA (both its GQA form and K/V
   expanded to every query head; K7-K9 at smollm's, olmoe's and
   recurrentgemma's head layouts);
2c. the paper's arithmetic: the elementwise and divide kernels bit-exact
   against their plain versions (every posit8 pair at es 0..4, every
   posit8es2 fma triple, 2^26 seeded posit16 pairs and the edge patterns
   against all 65,536), Table II's wrong-% on the card, the quire GEMM
   (posit16 in and out, M = 1024 at smollm-360m's shapes) against its
   plain version and repeated bit-identical, their timings, and the arithmetic main path: `pnp` arrays
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
6. the MoE path, olmoe-1b-7b at full width: (a) the grouped posit GEMM
   (K10; posit16, posit8 and f32 experts, with and without transpose_b)
   over every posit16/posit8 pattern bit-exact at K = 1 in its decode
   and tiled forms, then K10 and its dW (K11) against their plain
   versions within the f32 dot-product bound (plus, for f32 x f32, the
   2^-22 (|a| @ |b|) the tiled form declares), at a decode step's, a
   prefill step's and a training step's row counts and at edge layouts
   of 500 rows (the decode form) and 2,000 (the tiled form): empty
   groups, one group holding every row, boundaries inside a tile, rows
   past offsets[E], which must be exactly 0; every launch repeated
   bit-identical and in the form its plan names (the decode form for
   posit experts below 16 rows a group); (b) their timings beside the
   plain versions, the bound (bytes at decode, else the tensor cores'
   bf16 products, with the FFMA bound beside it) and one torch.matmul
   per non-empty group;
   (c) serving all 16 layers from posit16 experts, 16 requests through
   PagedServingEngine, counters zeroed just before the PTQ and read just
   after the drain (every decode step's grouped GEMMs in the decode form,
   training's in the tiled form), then a profiled decode window; (d) logits at depth 2
   on the card against the CPU, and (e) one depth-2 training step against
   the CPU, both under the route-flip rule (a token whose top-8 set
   differs between card and CPU must have a CPU logit margin within the
   router's f32 bound, and what it touched is left out of the
   comparison); then `train_loop` at depth 4 of 16 for 8 posit16 steps
   of 8 x 512 tokens (counted, with a profiled step) and one depth-2
   step repeated from the same state, bit-identical;
7. the recurrent and hybrid serving path: (a) the direct posit round
   trip (K12's, K13's and K1's) against posit_decode(posit_encode()) over
   all 2^32 f32 patterns (P16_2 and P8_2 compiled for their format, and
   at run time with five more formats); the WKV scan (K12) and the
   RG-LRU scan (K13) against their plain versions at rwkv6-3b's and
   recurrentgemma-9b's serving shapes (T = 1, 37, 128 and 130, the odd
   ones leaving a partial staging chunk; posit16, posit8, round-tripped
   f32 and f32 state; ragged num_new with a 0), and their generic paths
   (K12 at head_dim 18 and on misaligned inputs, K13 at width 4,097 and
   misaligned): final state and K13's outputs bit-identical, K12's y
   within the f32 bound, every launch repeated bit-identical; the paged
   attention (K3/K4) at head_dim 256 with 16 query heads per kv head,
   window 2,048 and the pages before it reclaimed to a garbage page of NaR
   patterns, every launch repeated bit-identical; the [BH, Sq, D]
   attention (K14, D = 64, 256 and 80); their
   timings beside the plain versions, the bound and SDPA for K14 (at D =
   64 and 256), and a counted
   `ops.attention` run; (b) rwkv6-3b and recurrentgemma-9b at full width
   and depth from posit16 weights, KV and state pools, 16 requests (and
   two 2,176-token prompts past recurrentgemma's window) through
   PagedServingEngine, counted as in phase 3, each with a profiled decode
   window and a profiled prefill step (8 x 128 tokens, device time by
   kernel); (c) logits at full width (rwkv6 depth 2, recurrentgemma depth
   3) on the card against the CPU, with the state patterns that differ
   (rwkv6's whole-model number reported only), and rwkv6 layer by layer:
   the CPU runs each layer from the card's own inputs and state patterns,
   each output and the head's logits within LOGITS_TOL;
   (d) smoke drains of both, card against CPU, token for token;
4. ``kernels: {...}`` with each kernel's launches on its main path (and
   the split-K reduces of the tiled GEMM, `pw_gemm_reduce` on the serving
   path and `posit_gemm_reduce` on the arithmetic path), the
   card's name and power limit, one JSON line of per-kernel numbers, and
   last the contract line ``{"ok": true, "device": {...}}``.

Float32 matmuls run in full f32 here and in the port (TF32 off).
``--out`` also writes every number to a JSON file.  ``--skinny-times``
runs only the skinny K2's timings at every M = 8 decode shape of
smollm-360m, rwkv6-3b and recurrentgemma-9b, and with ``--src`` another
commit's kernel under the same harness; ``--grouped-times`` does the same
for K10 and K11 at olmoe-1b-7b's decode, prefill and training shapes
(without the plain versions); ``--paged-times`` for K3 and K4 at
smollm-360m's and recurrentgemma-9b's layers beside SDPA (another commit's
kernels through that commit's own wrappers with ``--src``);
``--scan-times`` for K12 and K13 at a decode step's and a prefill chunk's
shapes of rwkv6-3b and recurrentgemma-9b (with ``--src``, another
commit's kernels through its own wrappers); ``--codec-times`` the same for
K1: decode, encode, the append at a prefill and a decode step, and the
round trip of one olmoe-1b-7b expert stack beside decode(encode()) (a
tree without the round trip times the two passes only); these two modes
build only the library they time; ``--prefill-traces`` runs
only the profiled prefill steps of those two models (with ``--src``,
another commit's kernels and engine).
``--flash-sass DIR`` compares the SASS of the contiguous flash kernels (K7
and K14, K8, K9) with those of another tree's unpacked ``src/`` (exit 1 if
an instance differs).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM, published (dense): HBM3 bandwidth, the f32 rate outside the
# tensor cores and the bf16 tensor-core rate.  Every kernel but the tiled
# posit GEMMs (K2 at M > 8 and every general-form call; K10 but its decode
# form; K11) uses FFMA, so f32 is their operation type; the tiled GEMMs run
# bf16 mma.sync on exact bf16 pieces of their operands (csrc/posit_gemm.cu,
# csrc/grouped_gemm.cu), so their operations are the bf16 products: 4 per
# f32 product for posit x posit, 6 otherwise.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

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
# K12's issue-rate estimate: warp instructions a state element and token on
# its fast path, counted in the SASS of the P16_2 instance's token loop
# (`cuobjdump -sass`): the y FFMA, two FMUL and an FADD of the update, 11
# integer operations and 2 FADD of the direct round trip, 4 of its branch;
# issued by 4 schedulers an SM at the card's top SM clock.  An estimate of
# the kernel's own code, not a bound on the work.
K12_INSTR_PER_ELEMENT = 21


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


def cuobjdump_sass(lib_path: str) -> str:
    """`cuobjdump -sass` of a built library (the toolkit's, beside nvcc)."""
    from repro_torch.kernels.build import nvcc
    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def sass_per_lane(lib_path: str, kernel: str, lanes: int):
    """SASS instructions per lane of one kernel instantiation, from
    `cuobjdump -sass` on the built library: the static instruction count
    of its main loop (the span of its longest backward branch: the 16-byte
    vector loop), over the `lanes` one pass of that loop handles.  A
    diagnostic, not a bound: it counts the kernel's own code, unrolled
    copies and branches no lane takes included.  Returns (count, method);
    raises when the count cannot be read."""
    import re
    for chunk in cuobjdump_sass(lib_path).split("Function : ")[1:]:
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


def sass_functions(lib_path: str, kernels: tuple[str, ...]) -> dict:
    """{symbol from the kernel's name on (the namespace's mangling cut):
    its SASS text, addresses cut} of every function of `lib_path` whose
    symbol names one of `kernels` (followed by its template arguments),
    from `cuobjdump -sass`."""
    import re
    funcs = {}
    for chunk in cuobjdump_sass(lib_path).split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        for k in kernels:
            if f"{k}I" in name:
                funcs[name[name.index(f"{k}I"):]] = "\n".join(re.findall(
                    r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", chunk))
    return funcs


def flash_sass_same(other_src: str) -> dict:
    """The contiguous flash kernels' SASS (K7 and K14's flash_fwd_kernel,
    K8, K9) in this tree's flash_prefill library against another tree's
    (`other_src`: its unpacked src/), built alike: per kernel, the
    instances and how many are identical instruction for instruction."""
    from repro_torch.kernels import build
    build.build_all(("flash_prefill",))
    here = build.library_path("flash_prefill")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; "
            "build.build_all(('flash_prefill',)); "
            "print(build.library_path('flash_prefill'))")
    there = subprocess.run([sys.executable, "-c", code, other_src],
                           capture_output=True, text=True, timeout=900,
                           check=True).stdout.strip().splitlines()[-1]
    names = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
             "flash_bwd_dkv_kernel")
    a, b = sass_functions(str(here), names), sass_functions(there, names)
    res = {}
    for k in names:
        mine = {n: t for n, t in a.items() if n.startswith(f"{k}I")}
        res[k] = {"instances": len(mine),
                  "identical": sum(b.get(n) == t for n, t in mine.items()),
                  "differ": sorted(n for n, t in mine.items()
                                   if b.get(n) != t)}
    return res


def ptxas_report(build, lib: str, kernels: tuple[str, ...]) -> list[dict]:
    """Registers and spill bytes of every instance of `kernels` in `lib`,
    from the `-Xptxas -v` log its build left; raises if one spills."""
    import re
    text = (build.BUILD_DIR / f"{lib}.log").read_text()
    rows = []
    for m in re.finditer(r"Compiling entry function '(\w+)'(.*?)Used (\d+) "
                         r"registers", text, re.S):
        name = next((k for k in kernels if k in m.group(1)), None)
        if name is None:
            continue
        spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill",
                                               m.group(2)))
        rows.append({"kernel": name, "symbol": m.group(1),
                     "registers": int(m.group(3)), "spill_bytes": spill})
    if not rows:
        raise RuntimeError(f"no {kernels} in {lib}'s ptxas log")
    bad = [r["symbol"] for r in rows if r["spill_bytes"]]
    if bad:
        raise AssertionError(f"ptxas spills in {bad}")
    return rows


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time in ms for the work, and which resource sets it."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def gemm_products(cfg_a, cfg_b) -> int:
    """bf16 products per f32 product in the tiled K2: two pieces per posit
    operand, three per f32 one, f32 x f32 keeping 6 of 9."""
    return 4 if cfg_a is not None and cfg_b is not None else 6


def tc_bound(nbytes: float, flops: float,
             products: int) -> tuple[float, str, float]:
    """The tiled K2's bound: the larger of bytes over HBM and its bf16
    products (`products` per f32 product of `flops`) over the tensor-core
    rate; and, beside it, the FFMA bound of the same f32 work."""
    tb, tf = nbytes / HBM_BYTES_PER_S, products * flops / BF16_FLOP_PER_S
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations",
            bound(nbytes, flops)[0])


def gemm_tol(torch, af, bf, K: int, f32xf32: bool):
    """The tiled K2's error bound against the plain version: the f32
    dot-product bound 2 K 2^-24 (|a| @ |b|) of two summation orders, plus
    for f32 x f32 the declared 2^-22 (|a| @ |b|) of the three piece
    products it drops (csrc/posit_gemm.cu).  af, bf: [M, K], [K, N]
    values."""
    s = af.abs().double() @ bf.abs().double()
    return (2 * K * 2.0 ** -24 + (2.0 ** -22 if f32xf32 else 0.0)) * s


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
        """K1 against its plain versions, bit for bit: the decode over
        every pattern and the encode and round trip over an f32 sweep for
        P16_2, P16_1, P8_2 and P8_0; then `check_codec_all_f32` and
        `check_codec_layouts`."""
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
            got = C.round_trip_block(sweep, cfg)
            want_r = C.round_trip_block_plain(sweep, cfg)
            bad_r = int((got.view(torch.int32)
                         != want_r.view(torch.int32)).sum())
            log(f"[codec] encode and round trip {cfg}: {sweep.numel()} f32 "
                f"values (+-0, subnormals, Inf, NaN, random bits, posit "
                f"values +-1 ulp), {bad} and {bad_r} mismatches (bit-exact "
                f"required)")
            if bad or bad_r:
                raise AssertionError(f"encode_block / round_trip_block "
                                     f"{cfg}: {bad} / {bad_r} mismatches")
        self.check_codec_all_f32()
        self.check_codec_layouts()
        for name in ("decode_block", "encode_block", "round_trip_block"):
            self.err(name, 0.0)

    def check_codec_all_f32(self):
        """K1's encode and round trip against their plain versions on every
        one of the 2^32 f32 patterns, in chunks of 2^27: P16_2 and P8_2
        (compiled for their format) and P16_1 (the runtime instance)."""
        torch = self.torch
        from repro_torch.core.types import P8_2, P16_1, P16_2
        from repro_torch.kernels import posit_codec as C
        chunk = 1 << 27
        t0 = time.perf_counter()
        rows = {}
        for cfg in (P16_2, P8_2, P16_1):
            bad_e = bad_r = 0
            first = None
            for lo in range(-(1 << 31), 1 << 31, chunk):
                x = torch.arange(lo, lo + chunk, dtype=torch.int64,
                                 device=self.dev).to(torch.int32).view(
                                     torch.float32)
                e = (C.encode_block(x, cfg)
                     != C.encode_block_plain(x, cfg))
                r = (C.round_trip_block(x, cfg).view(torch.int32)
                     != C.round_trip_block_plain(x, cfg).view(torch.int32))
                nb_e, nb_r = int(e.sum()), int(r.sum())
                if (nb_e or nb_r) and first is None:
                    idx = int(torch.nonzero(e | r)[0, 0])
                    first = (lo + idx) & 0xFFFFFFFF
                bad_e, bad_r = bad_e + nb_e, bad_r + nb_r
                del x, e, r
            rows[str(cfg)] = {"encode": bad_e, "round_trip": bad_r}
            if bad_e or bad_r:
                raise AssertionError(
                    f"{cfg}: {bad_e} encodes and {bad_r} round trips of the "
                    f"2^32 f32 patterns differ from the plain versions, the "
                    f"first {first:#010x}")
        torch.cuda.empty_cache()
        self.details["codec_all_f32_mismatches"] = rows
        log(f"[codec] encode_block and round_trip_block equal their plain "
            f"versions on all 2^32 f32 patterns for {', '.join(rows)} "
            f"({time.perf_counter() - t0:.1f} s)")

    def _codec_direct(self, kind, x, cfg, off):
        """One K1 pass through its C entry, both sides starting `off`
        elements into a fresh buffer (so the split's head is a lane run
        before the float4 steps, which the wrappers' fresh outputs never
        give), against the plain version; returns the split used."""
        torch = self.torch
        from repro_torch.kernels import build
        from repro_torch.kernels import posit_codec as C
        lib = build.library("posit_codec")
        n = x.numel()
        if kind == "decode":
            src = torch.empty(n + off, dtype=x.dtype, device=self.dev)[off:]
            dst = torch.empty(n + off, dtype=torch.float32,
                              device=self.dev)[off:]
            src.copy_(x)
            head, nvec = C.codec_split(n, dst.data_ptr(), src.data_ptr(),
                                       src.element_size())
            rc = lib.posit_decode_block(src.data_ptr(), dst.data_ptr(), n,
                                        head, nvec,
                                        build.DTYPE_CODE[src.dtype], cfg.n,
                                        cfg.es, build.stream(src))
            want = C.decode_block_plain(x, cfg)
        elif kind == "encode":
            dt = getattr(torch, cfg.storage_dtype_name)
            src = torch.empty(n + off, dtype=torch.float32,
                              device=self.dev)[off:]
            dst = torch.empty(n + off, dtype=dt, device=self.dev)[off:]
            src.copy_(x)
            head, nvec = C.codec_split(n, src.data_ptr(), dst.data_ptr(),
                                       dst.element_size())
            rc = lib.posit_encode_block(src.data_ptr(), dst.data_ptr(), n,
                                        head, nvec, build.DTYPE_CODE[dt],
                                        cfg.n, cfg.es, build.stream(src))
            want = C.encode_block_plain(x, cfg)
        else:
            src = torch.empty(n + off, dtype=torch.float32,
                              device=self.dev)[off:]
            dst = torch.empty(n + off, dtype=torch.float32,
                              device=self.dev)[off:]
            src.copy_(x)
            head, nvec = C.codec_split(n, src.data_ptr(), dst.data_ptr(), 4)
            rc = lib.posit_round_trip_block(src.data_ptr(), dst.data_ptr(),
                                            n, head, nvec, cfg.n, cfg.es,
                                            build.stream(src))
            want = C.round_trip_block_plain(x, cfg)
        build.check_launch(rc, f"posit {kind} at offset {off}")
        if dst.element_size() == 4:
            bad = int((dst.view(torch.int32) != want.view(torch.int32)).sum())
        else:
            bad = int((dst != want).sum())
        if bad:
            raise AssertionError(f"{kind} {cfg}, {n} elements at offset "
                                 f"{off}: {bad} mismatches")
        return head, nvec

    def check_codec_layouts(self):
        """Every K1 entry on ragged lengths and misaligned operands, bit for
        bit against its plain version: through the wrappers on views that
        start 1-15 elements into a buffer (every element then a lane where
        no step fits both sides) at lengths around a step, and
        through the C entries with both sides offset alike (a head of lanes,
        float4 steps, a tail), and with the wrong split, which must be
        refused."""
        torch = self.torch
        from repro_torch.core.types import P8_0, P8_2, P16_1, P16_2
        from repro_torch.kernels import build
        from repro_torch.kernels import posit_codec as C
        lens = (1, 3, 7, 8, 9, 15, 16, 17, 31, 33, 1000, 65537, 1 << 20)
        splits = set()
        cases = 0
        for cfg in (P16_2, P8_2, P16_1, P8_0):
            dt = getattr(torch, cfg.storage_dtype_name)
            for n in lens:
                x = self.randn(n, scale=4.0)
                bits = C.encode_block_plain(x, cfg)
                for off in (0, 1, 3, 5, 15):
                    fb = torch.empty(n + off, device=self.dev)[off:]
                    fb.copy_(x)
                    pb = torch.empty(n + off, dtype=dt, device=self.dev)[off:]
                    pb.copy_(bits)
                    self._same(f"decode {cfg} n={n} off={off}",
                               C.decode_block(pb, cfg).view(torch.int32),
                               C.decode_block_plain(pb, cfg).view(
                                   torch.int32))
                    self._same(f"encode {cfg} n={n} off={off}",
                               C.encode_block(fb, cfg),
                               C.encode_block_plain(fb, cfg))
                    self._same(f"round trip {cfg} n={n} off={off}",
                               C.round_trip_block(fb, cfg).view(torch.int32),
                               C.round_trip_block_plain(fb, cfg).view(
                                   torch.int32))
                    for kind in ("decode", "encode", "round_trip"):
                        src = bits if kind == "decode" else x
                        head, nvec = self._codec_direct(kind, src, cfg, off)
                        splits.add((kind, head > 0, nvec > 0))
                        cases += 4
        # the split must be the source's: a shifted one is refused
        lib = build.library("posit_codec")
        x = self.randn(1000)
        out = torch.empty(1000, dtype=torch.int16, device=self.dev)
        rc = lib.posit_encode_block(x.data_ptr(), out.data_ptr(), 1000, 1,
                                    124, build.DTYPE_CODE[torch.int16], 16, 2,
                                    build.stream(x))
        if rc != 9:
            raise AssertionError(f"posit_encode_block took a split that is "
                                 f"not its own (rc {rc})")
        heads = {k for k, h, v in splits if h and v}
        if heads != {"decode", "encode", "round_trip"}:
            raise AssertionError(f"no head-and-steps split ran for "
                                 f"{ {'decode', 'encode', 'round_trip'} - heads}")
        log(f"[codec] {cases} ragged and misaligned calls of decode, encode "
            f"and the round trip (P16_2, P8_2, P16_1, P8_0; lengths "
            f"{lens[0]}..{lens[-1]}, offsets 0-15 elements; lane runs, "
            f"heads, float4 steps and tails) bit-exact; a foreign split "
            f"refused")

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
        """The fused KV append against its plain version, byte for byte, in
        posit16, posit8 and float pages: a prefill step [8,5,128,64] with
        masked tokens (num_new 91, 0, 17), positions past the table, table
        entries of -1 and past the pool; a decode step [8,5,1,64]; the smoke
        configs' head_dim 20 and 256 (the row's lanes at D % 8 == 4 and 64
        chunks); head_dim 18 and k, v starting 4 bytes off a 16-byte
        boundary (element by element)."""
        torch = self.torch
        from repro_torch.core.types import P8_2, P16_2
        from repro_torch.kernels import posit_codec as C
        n_kv, page, W, P = 5, 16, 34, 300
        sl = torch.tensor([0, 16, 37, 128, 200, 300, 411, 500],
                          dtype=torch.int32, device=self.dev)
        table = torch.randperm(P - 1, generator=self.gen, device=self.dev)
        table = (table[:8 * W] + 1).reshape(8, W).to(torch.int32)
        table[1, 3] = -1                          # dropped: no page
        table[2, 3] = P + 7                       # dropped: outside the pool
        cases = [("prefill [8,5,128,64]", 128, 64, [128, 128, 91, 0, 128,
                                                     17, 128, 128], False),
                 ("decode [8,5,1,64]", 1, 64, [1, 1, 1, 0, 1, 1, 1, 1],
                  False),
                 ("head_dim 20", 37, 20, [37, 30, 37, 0, 5, 37, 37, 37],
                  False),
                 ("head_dim 256", 19, 256, [19, 19, 3, 0, 19, 19, 19, 19],
                  False),
                 ("head_dim 18", 37, 18, [37, 30, 37, 0, 5, 37, 37, 37],
                  False),
                 ("misaligned k, v", 37, 64, [37, 30, 37, 0, 5, 37, 37, 37],
                  True)]
        for label, S, D, new, shift in cases:
            nn = torch.tensor(new, dtype=torch.int32, device=self.dev)
            k, v = self.randn(8, n_kv, S, D), self.randn(8, n_kv, S, D)
            if shift:
                k, v = self._misaligned(k), self._misaligned(v)
            for cfg in (P16_2, P8_2, None):
                dt = (torch.float32 if cfg is None
                      else getattr(torch, cfg.storage_dtype_name))
                pools = [torch.zeros((P, n_kv, page, D), dtype=dt,
                                     device=self.dev) for _ in range(4)]
                C.paged_append(k, v, pools[0], pools[1], table, sl, nn, cfg)
                C.paged_append_plain(k, v, pools[2], pools[3], table, sl, nn,
                                     cfg)
                bad = sum(int((a.view(torch.uint8)
                               != b.view(torch.uint8)).sum())
                          for a, b in ((pools[0], pools[2]),
                                       (pools[1], pools[3])))
                if bad:
                    raise AssertionError(f"paged_append {cfg} {label}: {bad} "
                                         f"byte mismatches")
        log("[append] posit16, posit8 and float pages at " + ", ".join(
            c[0] for c in cases) + ", with masked tokens, positions past the "
            "table and table entries of -1 and past the pool: 0 byte "
            "mismatches (bit-exact required)")
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
                    self._repeat_same(f"pw_gemm {cfg} {name} M={M}", got,
                                      G.pw_gemm(x, w, cfg, transpose_b=tb))
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

    def _repeat_same(self, label, got, again):
        """A launch repeated on the same inputs: bit-identical (fixed
        summation order; K2's split-K reduced in slice order, the skinny
        form's and K3's clusters in rank order)."""
        torch = self.torch
        if got.dtype == torch.float32:
            got, again = got.view(torch.int32), again.view(torch.int32)
        if not torch.equal(got, again):
            raise AssertionError(f"{label}: a repeated launch differs")

    def check_gemm_edges(self):
        """The tiled K2 at edge shapes: M in {9, 24, 129}, N = 100, K in
        {1, 7, 33}, and two split-K shapes (200 x 300 and 960 x 320 over K =
        4,096), with f32, posit8 and posit16 A and B in every combination
        and every transpose_a / transpose_b, f32 out and posit16 out; the
        pw form at the same edge shapes with posit8 and posit16 weights.
        Each within `gemm_tol` of the plain version, posit out equal to
        the one rounding of the kernel's own f32 result, and every form
        launched twice bit-identical."""
        torch = self.torch
        from repro_torch.core.types import P8_2, P16_2
        from repro_torch.kernels import posit_gemm as G
        from repro_torch.kernels import ref

        def operand(cfg, shape, scale=1.0):
            x = self.randn(*shape, scale=scale)
            if cfg is None:
                return x, x
            bits = ref.encode_ref(x, cfg)
            return bits, ref.decode_ref(bits, cfg)

        worst, cases, split = 0.0, 0, 0
        shapes = [(M, 100, K) for M in (9, 24, 129) for K in (1, 7, 33)]
        shapes += [(200, 300, 4096), (960, 320, 4096)]
        for M, N, K in shapes:
            for ca, cb in itertools.product((None, P8_2, P16_2), repeat=2):
                for ta, tb in itertools.product((False, True), repeat=2):
                    a, af = operand(ca, (K, M) if ta else (M, K))
                    b, bf = operand(cb, (N, K) if tb else (K, N), K ** -0.5)
                    kw = dict(cfg_a=ca, cfg_b=cb, transpose_a=ta,
                              transpose_b=tb)
                    label = (f"posit_gemm {ca or 'f32'} x {cb or 'f32'} M={M} "
                             f"N={N} K={K} ta={ta} tb={tb}")
                    got = G.posit_gemm(a, b, **kw)
                    self._repeat_same(label, got, G.posit_gemm(a, b, **kw))
                    want = G.posit_gemm_plain(a, b, **kw)
                    tol = gemm_tol(torch, af.T if ta else af,
                                   bf.T if tb else bf, K,
                                   ca is None and cb is None)
                    diff = (got.double() - want.double()).abs()
                    ratio = float((diff / (tol + 1e-300)).max())
                    self.err("posit_gemm", diff.max())
                    pos = G.posit_gemm(a, b, cfg_out=P16_2, out_posit=True,
                                       **kw)
                    self._repeat_same(label + " posit out", pos, G.posit_gemm(
                        a, b, cfg_out=P16_2, out_posit=True, **kw))
                    self._same(label + " posit out", pos,
                               ref.encode_ref(got, P16_2))
                    worst = max(worst, ratio)
                    cases += 1
                    plan = G.gemm_plan(M, N, K, tuple(
                        "f32" if c is None else "posit" for c in (ca, cb)),
                        ta, tb)
                    split += plan.splits > 1
                    if ratio > 1.0:
                        raise AssertionError(f"{label}: error {ratio:.3e} of "
                                             f"the bound")
            log(f"[gemm edge] M={M} N={N} K={K}: 9 operand kinds x 4 "
                f"transposes within bound, posit out one rounding, repeats "
                f"bit-identical (worst err/bound so far {worst:.3e})")
        for M, K in itertools.product((9, 24, 129), (1, 7, 33)):
            for cfg, tb in itertools.product((P8_2, P16_2), (False, True)):
                x = self.randn(M, K)
                w, wf = operand(cfg, (100, K) if tb else (K, 100), K ** -0.5)
                label = f"pw_gemm {cfg} M={M} N=100 K={K} tb={tb}"
                got = G.pw_gemm(x, w, cfg, transpose_b=tb)
                self._repeat_same(label, got, G.pw_gemm(x, w, cfg,
                                                        transpose_b=tb))
                want = G.pw_gemm_plain(x, w, cfg, tb)
                tol = gemm_tol(torch, x, wf.T if tb else wf, K, False)
                diff = (got.double() - want.double()).abs()
                ratio = float((diff / (tol + 1e-300)).max())
                self.err("pw_gemm", diff.max())
                worst = max(worst, ratio)
                cases += 1
                if ratio > 1.0:
                    raise AssertionError(f"{label}: error {ratio:.3e} of the "
                                         f"bound")
        self.details["gemm_edges"] = {"cases": cases, "split_k_cases": split,
                                      "worst_err_over_bound": worst}
        log(f"[gemm edge] {cases} cases ({split} split-K), worst err/bound "
            f"{worst:.3e}")

    # ---- phase 2: K2's skinny form (M <= 8, the decode step) -------------
    def _posit_randn(self, shape, cfg, scale):
        """Posit bits of N(0, scale^2) values, encoded 2^26 at a time (the
        plain encode of a billion-entry table at once runs out of memory)."""
        torch = self.torch
        from repro_torch.kernels import ref
        out = torch.empty(shape, dtype=getattr(torch, cfg.storage_dtype_name),
                          device=self.dev)
        flat = out.view(-1)
        for i in range(0, flat.numel(), 1 << 26):
            n = min(1 << 26, flat.numel() - i)
            flat[i:i + n] = ref.encode_ref(self.randn(n, scale=scale), cfg)
        return out

    def _skinny_case(self, label, x, w, cfg, tb):
        """One skinny pw_gemm launched twice, bit-identical, and against
        pw_gemm_plain within the f32 dot-product bound, both taken over
        blocks of 2^26 weights (output columns).  Returns err / bound."""
        torch = self.torch
        from repro_torch.kernels import posit_gemm as G
        from repro_torch.kernels import ref
        got = G.pw_gemm(x, w, cfg, transpose_b=tb)
        self._repeat_same(label, got, G.pw_gemm(x, w, cfg, transpose_b=tb))
        K = x.shape[1]
        N = got.shape[1]
        step = max(1, (1 << 26) // max(K, 1))
        ratio = 0.0
        for n0 in range(0, N, step):
            wc = (w[n0:n0 + step] if tb else w[:, n0:n0 + step]).contiguous()
            want = G.pw_gemm_plain(x, wc, cfg, tb)
            wf = ref.decode_ref(wc, cfg)
            tol = gemm_tol(torch, x, wf.T if tb else wf, K, False)
            diff = (got[:, n0:n0 + step].double() - want.double()).abs()
            ratio = max(ratio, float((diff / (tol + 1e-300)).max()))
            self.err("pw_gemm", diff.max())
            del wc, want, wf, tol, diff
        if not ratio <= 1.0:
            raise AssertionError(f"{label}: error {ratio:.3e} of the bound")
        return ratio

    def check_skinny(self):
        """K2's skinny form (pw_gemm at M <= 8): (a) the decode of every
        posit16 and posit8 pattern, bit for bit against ref.decode_ref (NaR
        -> NaN), through K = 1 GEMMs with x = 1 at M = 1 and 8 in both
        orientations, for the specialised P16_2, the posit8 table (P8_2, and
        P8_0 as another int8 format) and the runtime-format P16_1; (b) M in {1, 3, 8} x N in {1, 100,
        1,000} x K in {1, 7, 33, 4,096}, posit8 and posit16, both
        orientations; (c) every served decode shape of the four models at
        M = 8, posit16 and posit8; (b) and (c) within the f32 dot-product
        bound of pw_gemm_plain; every case launched twice, bit-identical."""
        torch = self.torch
        from repro_torch.core.types import P8_0, P8_2, P16_1, P16_2
        from repro_torch.kernels import posit_gemm as G
        from repro_torch.kernels import ref
        for cfg in (P16_2, P16_1, P8_2, P8_0):
            dt = getattr(torch, cfg.storage_dtype_name)
            pats = torch.arange(-(1 << (cfg.n - 1)), 1 << (cfg.n - 1),
                                device=self.dev, dtype=torch.int32).to(dt)
            want = ref.decode_ref(pats, cfg)
            fin = torch.isfinite(want)
            for M, tb in itertools.product((1, 8), (False, True)):
                x = torch.ones((M, 1), device=self.dev)
                w = pats[:, None] if tb else pats[None, :]
                label = f"pw_gemm decode {cfg} M={M} tb={tb}"
                got = G.pw_gemm(x, w, cfg, transpose_b=tb)
                self._repeat_same(label, got, G.pw_gemm(x, w, cfg,
                                                        transpose_b=tb))
                bad = int((got[:, fin].view(torch.int32)
                           != want[fin].view(torch.int32)).sum())
                bad += int((~torch.isnan(got[:, ~fin])).sum())
                if bad:
                    raise AssertionError(f"{label}: {bad} values differ "
                                         f"from decode_ref")
            log(f"[skinny] decode {cfg}: all {pats.numel()} patterns, M 1 "
                f"and 8, both orientations, bit-exact (NaR -> NaN)")

        worst, cases = 0.0, 0
        for M, N, K in itertools.product((1, 3, 8), (1, 100, 1000),
                                         (1, 7, 33, 4096)):
            for cfg, tb in itertools.product((P8_2, P16_2), (False, True)):
                x = self.randn(M, K)
                w = self._posit_randn((N, K) if tb else (K, N), cfg,
                                      K ** -0.5)
                worst = max(worst, self._skinny_case(
                    f"pw_gemm {cfg} M={M} N={N} K={K} tb={tb}", x, w, cfg,
                    tb))
                cases += 1
        log(f"[skinny] edge shapes: {cases} cases within bound, repeats "
            f"bit-identical (worst err/bound {worst:.3e})")
        served = []
        for arch in SKINNY_ARCHS:
            for (K, N, tb), _ in served_decode_shapes(arch).items():
                for cfg in (P16_2, P8_2):
                    x = self.randn(DECODE_ROWS, K)
                    w = self._posit_randn((N, K) if tb else (K, N), cfg,
                                          K ** -0.5)
                    r = self._skinny_case(f"pw_gemm {arch} {cfg} K={K} N={N} "
                                          f"tb={tb}", x, w, cfg, tb)
                    del w
                    served.append({"arch": arch, "K": K, "N": N, "tb": tb,
                                   "cfg": str(cfg), "err_over_bound": r})
                    worst = max(worst, r)
                    cases += 1
                torch.cuda.empty_cache()
            log(f"[skinny] {arch}: every served decode shape at M = 8, "
                f"posit16 and posit8, within bound, repeats bit-identical")
        self.details["skinny_checks"] = {
            "cases": cases, "worst_err_over_bound": worst, "served": served}

    def time_skinny(self, archs=None):
        """K2's skinny form at every M = 8 decode shape of `archs` (default
        rwkv6-3b and recurrentgemma-9b; smollm-360m's shapes are timed in
        time_kernels), cold posit16 weights: the kernel, torch.matmul on
        the f32 weights, the plain version and the byte bound; and each
        model's decode step summed over its GEMMs."""
        torch = self.torch
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import posit_gemm as G
        from repro_torch.kernels import ref
        cfg, M = P16_2, DECODE_ROWS
        rows = self.details.setdefault("pw_gemm_model_shapes", [])
        steps = self.details.setdefault("pw_gemm_model_steps", {})
        for arch in archs or SKINNY_ARCHS[2:]:
            step = {"gemms": 0, "ms": 0.0, "library_ms": 0.0,
                    "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0}
            for (K, N, tb), count in served_decode_shapes(arch).items():
                nbytes = 4 * M * K + 2 * K * N + 4 * M * N
                ws = [self._posit_randn((N, K) if tb else (K, N), cfg,
                                        K ** -0.5)
                      for _ in range(copies_for(2 * K * N, 24))]
                x = self.randn(M, K)
                at = f"{arch} K={K} N={N} tb={tb}"
                kern = time_ms(torch, lambda w: G.pw_gemm(
                    x, w, cfg, transpose_b=tb), [(w,) for w in ws], ITERS,
                    f"pw_gemm {at}")
                # the plain version over blocks of output columns where the
                # whole table's decode would not fit beside the copies
                blk = N if K * N <= 1 << 28 else (1 << 26) // K

                def plain_fn(w):
                    return torch.cat([G.pw_gemm_plain(
                        x, w[n0:n0 + blk] if tb else w[:, n0:n0 + blk],
                        cfg, tb) for n0 in range(0, N, blk)], dim=1)

                plain = time_ms(torch, plain_fn, [(w,) for w in ws],
                                3 if K * N > 1 << 27 else 10,
                                f"pw_gemm_plain {at}")
                wfs = [torch.cat([ref.decode_ref(
                    w[n0:n0 + blk] if tb else w[:, n0:n0 + blk], cfg)
                    for n0 in range(0, N, blk)], dim=0 if tb else 1)
                    for w in ws[:copies_for(4 * K * N, 12)]]
                del ws
                lib = time_ms(torch, lambda wf: torch.matmul(
                    x, wf.T if tb else wf), [(wf,) for wf in wfs], ITERS,
                    f"torch.matmul {at}")
                del wfs
                torch.cuda.empty_cache()
                b, by = bound(nbytes, 2.0 * M * K * N)
                rows.append({"arch": arch, "M": M, "K": K, "N": N,
                             "transpose_b": tb, "per_step": count,
                             "ms": kern, "plain_ms": plain,
                             "library_ms": lib, "bound_ms": b,
                             "bound_by": by})
                log(f"[time] pw_gemm {at} M=8 (x{count} a step): "
                    f"{kern:.4f} ms (torch.matmul on f32 {lib:.4f}, plain "
                    f"{plain:.4f}, bound {b:.4f} by {by}: "
                    f"{nbytes / kern / 1e6:.0f} GB/s)")
                step["gemms"] += count
                step["ms"] += count * kern
                step["library_ms"] += count * lib
                step["plain_ms"] += count * plain
                step["bound_ms"] += count * b
                step["bytes"] += count * nbytes
            steps[arch] = step
            log(f"[time] pw_gemm {arch} decode step ({step['gemms']} GEMMs "
                f"at M=8): {step['ms']:.3f} ms, torch.matmul "
                f"{step['library_ms']:.3f}, bound {step['bound_ms']:.3f} "
                f"({step['ms'] / step['bound_ms']:.2f}x)")

    def skinny_sass(self):
        """Instructions per weight element in the main loop of the P16_2
        skinny kernel at M = 8, both orientations, from its SASS."""
        from repro_torch.kernels import build
        lib = str(build.library_path("posit_gemm"))
        out = {}
        for tb in (False, True):
            prof = sass_loop_profile(
                lib, f"pw_skinny_kernelILi1ELb{int(tb)}ELi8E", 8)
            out["transpose_b" if tb else "k_by_n"] = prof
            log(f"[skinny] SASS main loop, P16_2 M=8 tb={tb}: "
                f"{prof['fast_per_element']:.2f} instructions per element "
                f"on the fast path ({prof['fast_counts']} over "
                f"{prof['elements']} elements; {prof['per_element']:.2f} "
                f"with the flagged loads' posit_decode)")
        self.details["skinny_sass"] = out

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
                self._repeat_same(f"paged_flash_decode {fmt} window="
                                  f"{window}", got, F.paged_flash_decode(
                                      q, kp, vp, table, sl, cfg_kv=cfg,
                                      window=window))
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
                    self._repeat_same(
                        f"paged_flash_prefill {fmt} Sq={Sq} window={window} "
                        f"softcap={softcap}", got, F.paged_flash_prefill(
                            q, kp, vp, table, sl, qo, cfg_kv=cfg,
                            window=window, softcap=softcap))

    def check_attention_smoke_layout(self):
        """K3 and K4 at the smoke configs' head_dim 20 (smollm-360m's smoke
        layout: 6 query heads on 2 kv heads; D % 8 == 4), posit16, posit8
        and float pages, with a window, within ATTN_TOL and repeated
        bit-identical.  Its inputs come from a generator of its own, so
        the other phases' inputs stay as they were."""
        torch = self.torch
        from repro_torch.core.types import P8_2, P16_2
        from repro_torch.kernels import flash_attention as F
        saved = self.gen
        self.gen = torch.Generator(device=self.dev).manual_seed(20)
        try:
            B, H, n_kv, page, D, W, P = 4, 6, 2, 16, 20, 8, 40
            sl = torch.tensor([1, 40, 0, 128], dtype=torch.int32,
                              device=self.dev)
            qo = torch.tensor([0, 8, 0, 100], dtype=torch.int32,
                              device=self.dev)
            live = (sl > 0)[:, None, None].expand(B, H, D)
            rows = torch.arange(32, device=self.dev)
            plive = (rows[None, :] < (sl - qo)[:, None])[:, None, :, None]
            plive = plive.expand(B, H, 32, D)
            for cfg in (P16_2, P8_2, None):
                fmt = cfg or "float"
                kp, vp = self._pool(cfg, P, n_kv, page, D)
                table = self._table(B, W, P)
                q = self.randn(B, H, D)
                qq = self.randn(B, H, 32, D)
                for window in (None, 24):
                    got = F.paged_flash_decode(q, kp, vp, table, sl,
                                               cfg_kv=cfg, window=window)
                    want = F.paged_flash_decode_plain(
                        q, kp, vp, table, sl, cfg_kv=cfg, window=window)
                    self._compare_attn("paged_flash_decode",
                                       f"D=20 {fmt} window={window}", got,
                                       want, live, dead_zero=True)
                    self._repeat_same(f"paged_flash_decode D=20 {fmt}", got,
                                      F.paged_flash_decode(
                                          q, kp, vp, table, sl, cfg_kv=cfg,
                                          window=window))
                    got = F.paged_flash_prefill(qq, kp, vp, table, sl, qo,
                                                cfg_kv=cfg, window=window)
                    want = F.paged_flash_prefill_plain(
                        qq, kp, vp, table, sl, qo, cfg_kv=cfg,
                        window=window)
                    self._compare_attn("paged_flash_prefill",
                                       f"D=20 {fmt} window={window}", got,
                                       want, plive, dead_zero=False)
                    self._repeat_same(f"paged_flash_prefill D=20 {fmt}", got,
                                      F.paged_flash_prefill(
                                          qq, kp, vp, table, sl, qo,
                                          cfg_kv=cfg, window=window))
        finally:
            self.gen = saved

    def check_attention_bad_entries(self):
        """A visible key on a page-table entry outside the pool is dropped
        by K3 and by K4 alike.  At smollm-360m's layout and at D = 256, G =
        16, posit16 pages, one whole visible page of each of two sequences
        sits on entry -1 and on entry P + 5; K3 and K4 at Sq = 1 (the
        decode form, also with a softcap, which serving routes to K4) are
        held within ATTN_TOL against the plain version over the table with
        those pages taken out and seq_lens a page shorter: a decode query
        without a window sees every earlier key, so dropping a page is
        taking it out.  Rows that see no key are exactly 0, and K4 repeats
        bit-identical.  Its inputs come from a generator of its own, so
        the other phases' inputs stay as they were."""
        torch = self.torch
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import flash_attention as F
        saved = self.gen
        self.gen = torch.Generator(device=self.dev).manual_seed(23)
        try:
            B, page, W, P = 4, 16, 12, 60
            sl = torch.tensor([40, 100, 0, 17], dtype=torch.int32,
                              device=self.dev)
            short = sl - torch.tensor([page, page, 0, 0], dtype=torch.int32,
                                      device=self.dev)
            live = (sl > 0)[:, None, None]
            for H, n_kv, D in ((15, 5, 64), (16, 1, 256)):
                at = f"D={D} G={H // n_kv} entries outside the pool"
                kp, vp = self._pool(P16_2, P, n_kv, page, D)
                table = self._table(B, W, P)
                bad = table.clone()
                bad[0, 1] = -1
                bad[1, 3] = P + 5
                cut = table.clone()
                cut[0, 1:-1] = table[0, 2:]
                cut[1, 3:-1] = table[1, 4:]
                q = self.randn(B, H, D)
                got = F.paged_flash_decode(q, kp, vp, bad, sl, cfg_kv=P16_2)
                want = F.paged_flash_decode_plain(q, kp, vp, cut, short,
                                                  cfg_kv=P16_2)
                self._compare_attn("paged_flash_decode", at, got, want,
                                   live.expand(B, H, D), dead_zero=True)
                for softcap in (None, 30.0):
                    got = F.paged_flash_prefill(q[:, :, None], kp, vp, bad,
                                                sl, sl - 1, cfg_kv=P16_2,
                                                softcap=softcap)
                    want = F.paged_flash_prefill_plain(
                        q[:, :, None], kp, vp, cut, short, short - 1,
                        cfg_kv=P16_2, softcap=softcap)
                    self._compare_attn(
                        "paged_flash_prefill", f"{at} Sq=1 softcap="
                        f"{softcap}", got, want,
                        live[..., None].expand(B, H, 1, D), dead_zero=True)
                    self._repeat_same(
                        f"paged_flash_prefill {at} softcap={softcap}", got,
                        F.paged_flash_prefill(q[:, :, None], kp, vp, bad, sl,
                                              sl - 1, cfg_kv=P16_2,
                                              softcap=softcap))
        finally:
            self.gen = saved

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

        # K1: decode, encode, the round trip and the append
        rows = self.time_codec()
        for name, key in (("decode_block", "decode_block"),
                          ("encode_block", "encode_block"),
                          ("round_trip_block", "round_trip_block"),
                          ("paged_append", "paged_append prefill")):
            self.record(name, **{k: rows[key][k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})

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
                # M <= 8: the skinny FFMA kernels; above, the tensor cores
                b, by = bound(nbytes, 2.0 * M * K * N)
                ffma = b
                if M > G.SKINNY_M:
                    b, by, ffma = tc_bound(nbytes, 2.0 * M * K * N,
                                           gemm_products(None, cfg))
                rows.append({"shape": name, "M": M, "K": K, "N": N,
                             "per_step": count, "ms": kern,
                             "plain_ms": plain, "library_ms": lib,
                             "bound_ms": b, "bound_by": by,
                             "ffma_bound_ms": ffma})
                log(f"[time] pw_gemm {name} M={M}: {kern:.4f} ms (plain "
                    f"{plain:.4f}, torch.matmul on f32 {lib:.4f}, bound "
                    f"{b:.4f} by {by}; FFMA bound {ffma:.4f})")
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

        # K3 and K4 at smollm-360m's layer (the rows of PERF.md's table)
        rows = self.time_paged(("smollm",))
        for name, key in (("paged_flash_decode", "paged_flash_decode "
                           "smollm"), ("paged_flash_prefill",
                                       "paged_flash_prefill smollm")):
            rec = rows[key]
            self.record(name, shape=rec["shape"], ms=rec["ms"],
                        plain_ms=rec["plain_ms"],
                        library_ms=rec["library_ms"],
                        bound_ms=rec["bound_ms"], bound_by=rec["bound_by"])

    def time_codec(self, plain=True):
        """K1 at its main paths' shapes, posit16, cold L2: decode of one
        prefill step's embedding rows [8,128,960]; encode of one w_up
        table [960,2560] (PTQ); the append of a prefill step's and a decode
        step's K and V ([8,5,128,64], [8,5,1,64]); and the round trip of
        one olmoe-1b-7b expert stack [64,2048,1024] (the STE cast), beside
        decode_block(encode_block()) of the same stack and a PyTorch copy
        of it (the card's copy rate at the round trip's bytes).  The plain
        versions beside them unless `plain` is False.  A tree without
        round_trip_block (the parent, with --src) times the two passes
        only.  Returns {label: numbers}."""
        torch = self.torch
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import posit_codec as C
        from repro_torch.kernels import ref
        cfg, it = P16_2, ITERS
        rows = {}

        def row(label, shape, fn, plain_fn, sets, nbytes, iters=it,
                plain_iters=20):
            b, by = bound(nbytes, 0)
            rows[label] = {
                "shape": shape, "ms": time_ms(torch, fn, sets, iters, label),
                "plain_ms": (time_ms(torch, plain_fn, sets, plain_iters,
                                     f"{label} plain")
                             if plain and plain_fn else None),
                "bound_ms": b, "bound_by": by, "library_ms": None}

        shape = (8, 128, 960)
        n = math.prod(shape)
        sets = [(ref.encode_ref(self.randn(*shape), cfg), cfg)
                for _ in range(copies_for(6 * n, 16))]
        row("decode_block", "embed rows [8,128,960] p16", C.decode_block,
            C.decode_block_plain, sets, 6 * n)
        shape = (960, 2560)
        n = math.prod(shape)
        sets = [(self.randn(*shape), cfg) for _ in range(copies_for(6 * n,
                                                                    16))]
        row("encode_block", "PTQ of w_up [960,2560] -> p16", C.encode_block,
            C.encode_block_plain, sets, 6 * n)
        B, n_kv, D, page, W, P = 8, 5, 64, 16, 34, 273
        table = self._table(B, W, P)
        for S, label in ((128, "prefill"), (1, "decode")):
            sl = torch.full((B,), 128, dtype=torch.int32, device=self.dev)
            nn = torch.full((B,), S, dtype=torch.int32, device=self.dev)
            pools = [self._pool(cfg, P, n_kv, page, D) for _ in range(4)]
            sets = [(self.randn(B, n_kv, S, D), self.randn(B, n_kv, S, D),
                     kp, vp, table, sl, nn, cfg) for kp, vp in pools]
            n = B * n_kv * S * D
            row(f"paged_append {label}", f"{label} step K,V [8,5,{S},64] "
                f"f32 -> p16 pages", C.paged_append, C.paged_append_plain,
                sets, 2 * n * (4 + 2) + 2 * B * 4 + table.numel() * 4)
        # the STE cast of one expert stack: 134 M elements, 0.54 GB of f32
        shape = (64, 2048, 1024)
        n = math.prod(shape)
        sets = [(self.randn(*shape, scale=0.02), cfg) for _ in range(2)]
        one_pass = getattr(C, "round_trip_block", None)
        if one_pass is not None:
            row("round_trip_block", "STE cast of one olmoe expert stack "
                "[64,2048,1024] p16", one_pass, C.round_trip_block_plain,
                sets, 8 * n, iters=10, plain_iters=3)
        row("decode(encode()) two passes", "the same stack, encode_block "
            "then decode_block", lambda x, c: C.decode_block(
                C.encode_block(x, c), c), None, sets, 8 * n, iters=10)
        # a yardstick of the card's copy rate: one PyTorch copy of the
        # stack moves the round trip's bytes
        row("clone of the stack", "torch.clone of the same stack (a copy, "
            "not the function)", lambda x, c: x.clone(), None, sets, 8 * n,
            iters=10)
        del sets
        torch.cuda.empty_cache()
        card = self.details["gpu"]
        for label, rec in rows.items():
            pl = rec["plain_ms"]
            log(f"[time] {label} ({rec['shape']}): {rec['ms']:.4f} ms ("
                f"{'' if pl is None else f'plain {pl:.4f}, '}bound "
                f"{rec['bound_ms']:.4f} by {rec['bound_by']}) ({card})")
        self.details.setdefault("codec_times", {}).update(rows)
        return rows

    def time_paged(self, which=("smollm", "d256"), plain=True):
        """K3 and K4 at the shapes of PERF.md's kernel table, posit16
        pages, cold: ("smollm") one smollm-360m layer (15/5 heads, D = 64)
        of a decode step (8 sequences at 160..544 tokens) and of a prefill
        step (8 x 128 queries at offsets 0..384); ("d256") recurrentgemma-
        9b's attention (16 heads on one kv head, D = 256, window 2,048) at
        the same lengths and at 8 x 2,208 tokens, the pages before the
        window reclaimed to page 0.  Each beside the plain version (unless
        `plain` is False), one SDPA call over the gathered, decoded KV with
        the same masks, and the bound.  Returns {label: numbers}."""
        torch = self.torch
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import flash_attention as F
        cfg = P16_2
        lens = [160, 224, 300, 356, 420, 480, 512, 544]
        cases = []
        if "smollm" in which:
            cases.append(("smollm", 8, 15, 5, 64, None, lens, 273, False))
        if "d256" in which:
            cases += [("D=256 160..544", 8, 16, 1, 256, 2048, lens, None,
                       True),
                      ("D=256 8 x 2208", 8, 16, 1, 256, 2048, [2208] * 8,
                       None, True)]
        rows = {}
        for label, B, H, n_kv, D, win, lens_, P, reclaim in cases:
            page = 16
            sl = torch.tensor(lens_, dtype=torch.int32, device=self.dev)
            W = -(-max(lens_) // page)
            P = P or B * W + 1
            table = (self._reclaimed_table(B, W, P, sl - 1, win, page)
                     if reclaim else self._table(B, W, P))
            keys = int(torch.clamp(sl, max=win or 1 << 30).sum())
            nbytes = 2 * keys * n_kv * D * 2 + 2 * B * H * D * 4 + B * 4
            pools = [self._pool(cfg, P, n_kv, page, D)
                     for _ in range(copies_for(nbytes, 24 if D == 64
                                               else 8))]
            q = self.randn(B, H, D)
            sets = [(q, kp, vp, table, sl) for kp, vp in pools]
            bnd, by = bound(nbytes, 4.0 * keys * H * D)
            kern = time_ms(torch, lambda *a: F.paged_flash_decode(
                *a, cfg_kv=cfg, window=win), sets, ITERS,
                f"paged_flash_decode {label}")
            pl = (time_ms(torch, lambda *a: F.paged_flash_decode_plain(
                *a, cfg_kv=cfg, window=win), sets, 10 if D == 64 else 5,
                f"paged_flash_decode_plain {label}") if plain else None)
            lib = self._sdpa_ms(pools, table, sl, q[:, :, None, :], sl - 1,
                                causal=True, window=win)
            rows[f"paged_flash_decode {label}"] = dict(
                shape=f"one layer, decode step: {B} seqs, {label} "
                      f"({min(lens_)}..{max(lens_)} tokens), G={H // n_kv}, "
                      f"D={D}, window={win}, p16 pages",
                ms=kern, plain_ms=pl, library_ms=lib, bound_ms=bnd,
                bound_by=by)
            Sq = 128
            if reclaim:
                qo = (sl - Sq).clamp(min=0)
            else:
                qo = torch.tensor([0, 128, 256, 384, 0, 128, 256, 384],
                                  dtype=torch.int32, device=self.dev)
                sl = qo + Sq
            w_ = win or 1 << 30
            keys = int(sum(min(int(o) + i + 1, w_)
                           for o in qo.tolist() for i in range(Sq)))
            nbytes = (2 * int(torch.clamp(sl, max=w_ + Sq).sum()) * n_kv * D
                      * 2 + 2 * B * H * Sq * D * 4 + 2 * B * 4)
            qq = self.randn(B, H, Sq, D)
            if reclaim:
                table = self._reclaimed_table(B, W, P, qo, win, page)
            sets = [(qq, kp, vp, table, sl, qo) for kp, vp in pools]
            bnd, by = bound(nbytes, 4.0 * keys * H * D)
            kern = time_ms(torch, lambda *a: F.paged_flash_prefill(
                *a, cfg_kv=cfg, window=win), sets, ITERS,
                f"paged_flash_prefill {label}")
            pl = (time_ms(torch, lambda *a: F.paged_flash_prefill_plain(
                *a, cfg_kv=cfg, window=win), sets, 5 if D == 64 else 3,
                f"paged_flash_prefill_plain {label}") if plain else None)
            lib = self._sdpa_ms(pools, table, sl, qq, qo, causal=True,
                                window=win)
            rows[f"paged_flash_prefill {label}"] = dict(
                shape=f"one layer, prefill step: {B} x {Sq} queries over "
                      f"{int(sl.min())}..{int(sl.max())} keys, G="
                      f"{H // n_kv}, D={D}, window={win}, p16 pages",
                ms=kern, plain_ms=pl, library_ms=lib, bound_ms=bnd,
                bound_by=by)
            del pools, sets
            torch.cuda.empty_cache()
        card = self.details["gpu"]
        for name, rec in rows.items():
            pl = rec["plain_ms"]
            log(f"[time] {name}: {rec['ms']:.4f} ms ("
                f"{'' if pl is None else f'plain {pl:.4f}, '}SDPA "
                f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} by "
                f"{rec['bound_by']}) ({card})")
        self.details.setdefault("paged_kernel_times", {}).update(rows)
        return rows

    def _sdpa_ms(self, pools, table, sl, q, qo, causal, window=None):
        """One scaled_dot_product_attention call over the gathered, decoded
        dense KV (GQA grouped, masks as the kernel's, the window's too):
        the library yardstick, timed only."""
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
            if window is not None:
                mask = mask & (qpos[:, :, None] - kpos[None, None, :]
                               < window)
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

    def _check_flash_case(self, name, B, H, n_kv, Sq, Skv, D, causal, qo,
                          kl, window, softcap, cfg, repeat):
        """One case of `check_training_kernels`; returns the worst
        err/bound."""
        torch = self.torch
        from repro_torch.kernels import flash_attention as F
        from repro_torch.kernels import ref
        dev = self.dev
        q, do = self.randn(B, H, Sq, D), self.randn(B, H, Sq, D)
        k, v = self.randn(B, n_kv, Skv, D), self.randn(B, n_kv, Skv, D)
        if cfg is not None:
            k, v = ref.encode_ref(k, cfg), ref.encode_ref(v, cfg)
        qo = torch.tensor(qo or [0] * B, dtype=torch.int32, device=dev)
        kl = torch.tensor(kl or [Skv] * B, dtype=torch.int32, device=dev)
        kw = dict(cfg_kv=cfg, causal=causal, window=window, softcap=softcap)
        label = (f"{name} Sq={Sq} Skv={Skv} {cfg or 'f32'} KV causal="
                 f"{causal} window={window} softcap={softcap}")
        o, lse = F.flash_prefill_contiguous(q, k, v, kl, qo, return_lse=True,
                                            **kw)
        po, plse = F.flash_prefill_contiguous_plain(q, k, v, kl, qo,
                                                    return_lse=True, **kw)
        delta = (do * po).sum(-1)
        bkw = dict(causal=causal, window=window, softcap=softcap)
        dq, dk, dv = F.flash_prefill_bwd_contiguous(q, k, v, po, plse, do, kl,
                                                    qo, **kw)
        pdq, pdk, pdv = F.flash_prefill_bwd_contiguous_plain(
            q, k, v, po, plse, do, kl, qo, **kw)
        if (pdk is None) != (cfg is not None) or (dk is None) != (
                cfg is not None):
            raise AssertionError("dK/dV must be None exactly for posit KV")
        tol = self._attn_bounds(q, k, v, po, plse, do, kl, qo, cfg, causal,
                                window, softcap)
        worst = 0.0
        for kname, pairs in (
                ("flash_prefill", (("out", o, po), ("lse", lse, plse))),
                ("flash_prefill_bwd_dq", (("dq", dq, pdq),)),
                ("flash_prefill_bwd_dkv", (("dk", dk, pdk), ("dv", dv, pdv)))):
            for what, got, want in pairs:
                if got is None:
                    continue
                worst = max(worst, self._within(
                    kname, f"{what} {label}", got, want, tol[what]))
        del tol
        qpos = qo[:, None] + torch.arange(Sq, device=dev)[None, :]
        lo = torch.clamp(qpos - (window or Skv) + 1, min=0)
        hi = torch.minimum(kl[:, None], qpos + 1) if causal else kl[:, None]
        dead = (lo >= hi)[:, None, :].expand(B, H, Sq)
        n_dead = int(dead.sum())
        if n_dead and not all(bool((t[dead] == 0).all())
                              for t in (o, po, lse, plse, dq, pdq)
                              if t is not None):
            raise AssertionError(f"flash prefill {label}: rows that see no "
                                 f"key are not 0")
        log(f"[train-kernels] {label}: {n_dead} rows see no key, 0 on both "
            f"sides")
        if repeat:
            o2, lse2 = F.flash_prefill_contiguous(q, k, v, kl, qo,
                                                  return_lse=True, **kw)
            dq2 = F.flash_prefill_bwd_dq(q, k, v, do, plse, delta, kl, qo,
                                         **kw)
            dk1, dv1 = F.flash_prefill_bwd_dkv(q, k, v, do, plse, delta, kl,
                                               qo, **bkw)
            dk2, dv2 = F.flash_prefill_bwd_dkv(q, k, v, do, plse, delta, kl,
                                               qo, **bkw)
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)
                    and torch.equal(dq, dq2) and torch.equal(dk1, dk2)
                    and torch.equal(dv1, dv2)):
                raise AssertionError(f"{label}: a repeated launch of the "
                                     f"forward, K8 or K9 is not "
                                     f"bit-identical")
            log(f"[train-kernels] {label}: forward, K8 and K9 repeated, "
                f"bit-identical")
        return worst

    def check_training_kernels(self):
        """K7-K9 at each head layout of FLASH_LAYOUTS (smollm's G = 3, D =
        64; olmoe's G = 1, D = 128; recurrentgemma's G = 16, D = 256;
        hubert-xlarge's G = 1, D = 80, bidirectional), each at a training
        shape (8 x 512 queries over 512 f32 keys) and at an edge shape (128
        queries over 512 keys, per-batch q_offset and kv_len < Skv, window
        64, softcap 30; f32 and posit16 KV), against the plain versions
        within the bounds of `_attn_bounds`.  Rows that see no key must be
        exactly 0 on both sides, and the forward, K8 and K9 launched again
        on the training inputs must give bit-identical results.  Then
        posit_gemm's transpose_a (the dW leg) at the five training dW
        shapes and one posit16 A, within the f32 dot-product bound over K =
        4,096."""
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import posit_gemm as G
        from repro_torch.kernels import ref
        B, Skv = 8, 512
        worst = 0.0
        edge = ([0, 16, 100, 384, 200, 300, 7, 50],
                [128, 144, 228, 512, 328, 420, 135, 100], 64, 30.0)
        for arch, H, n_kv, D, train_causal in FLASH_LAYOUTS:
            cases = [("train", 512, train_causal, None, None, None, None,
                      None),
                     ("edge", 128, True, *edge, None),
                     ("edge", 128, True, *edge, P16_2)]
            for tag, Sq, causal, qo, kl, window, softcap, cfg in cases:
                worst = max(worst, self._check_flash_case(
                    f"{tag} {arch} H={H} n_kv={n_kv} D={D}", B, H, n_kv, Sq,
                    Skv, D, causal, qo, kl, window, softcap, cfg,
                    repeat=tag == "train"))
        K = 4096
        for M, N in DW_SHAPES:
            a, g = self.randn(K, M), self.randn(K, N)
            got = G.posit_gemm(a, g, cfg_a=None, cfg_b=None, transpose_a=True)
            label = (f"f32 A [K={K}, M={M}] N={N} (split-K "
                     f"{G.gemm_plan(M, N, K, ('f32', 'f32'), True).splits})")
            self._repeat_same(f"transpose_a {label}", got, G.posit_gemm(
                a, g, cfg_a=None, cfg_b=None, transpose_a=True))
            want = G.posit_gemm_plain(a, g, cfg_a=None, cfg_b=None,
                                      transpose_a=True)
            tol = gemm_tol(self.torch, a.T, g, K, True).float()
            worst = max(worst, self._within(
                "posit_gemm_transpose_a", label, got, want, tol))
            del a, g, got, want, tol
        a = ref.encode_ref(self.randn(K, 960), P16_2)
        g = self.randn(K, 320)
        tol = gemm_tol(self.torch, ref.decode_ref(a, P16_2).T, g, K,
                       False).float()
        got = G.posit_gemm(a, g, cfg_a=P16_2, cfg_b=None, transpose_a=True)
        self._repeat_same("transpose_a posit16 A", got, G.posit_gemm(
            a, g, cfg_a=P16_2, cfg_b=None, transpose_a=True))
        worst = max(worst, self._within(
            "posit_gemm_transpose_a", f"posit16 A [K={K}, M=960] N=320",
            got, G.posit_gemm_plain(a, g, cfg_a=P16_2, cfg_b=None,
                                    transpose_a=True), tol))
        self.details["training_kernels_worst_err_over_bound"] = worst

    def _time_flash(self, B, H, n_kv, S, D):
        """K7, K8 and K9 at [B, H, S, D] causal over n_kv f32 kv heads,
        each beside its plain version, its bound and two SDPA
        yardsticks: GQA (enable_gqa=True) and K/V expanded to H heads
        (repeat_interleave outside the timed region); the backward's
        yardstick is SDPA's forward+backward less its forward.  Causal work
        counts the B H S (S + 1) / 2 visible pairs; per pair the forward
        does 4 D flops (q.k and p v), dQ 6 D (q.k, dO.v, ds k) and dK/dV
        8 D (q.k, dO.v, p dO, ds q).  Returns {name: row}."""
        torch = self.torch
        from repro_torch.kernels import flash_attention as F
        dev = self.dev
        G = H // n_kv
        pairs = B * H * S * (S + 1) // 2
        q_bytes, kv_bytes, row_bytes = (4 * B * H * S * D,
                                        4 * B * n_kv * S * D, 4 * B * H * S)
        kl = torch.full((B,), S, dtype=torch.int32, device=dev)
        qo = torch.zeros((B,), dtype=torch.int32, device=dev)
        sets = []
        for _ in range(copies_for(4 * q_bytes + 2 * kv_bytes, 8)):
            q, do = self.randn(B, H, S, D), self.randn(B, H, S, D)
            k, v = self.randn(B, n_kv, S, D), self.randn(B, n_kv, S, D)
            o, lse = F.flash_prefill_contiguous_plain(q, k, v, kl, qo,
                                                      return_lse=True)
            delta = (do * o).sum(-1)
            sets.append((q, k, v, do, lse, delta, k.repeat_interleave(G, 1),
                         v.repeat_interleave(G, 1)))
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def lib_fwd(q, k, v, do, lse, delta, ke, ve, expanded):
            if expanded:
                return sdpa(q, ke, ve, is_causal=True)
            return sdpa(q, k, v, is_causal=True, enable_gqa=True)

        def lib_fwd_bwd(q, k, v, do, lse, delta, ke, ve, expanded):
            k, v = (ke, ve) if expanded else (k, v)
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            out = sdpa(q, k, v, is_causal=True, enable_gqa=not expanded)
            return torch.autograd.grad(out, (q, k, v), do)

        kern_fns = {
            "flash_prefill": (
                lambda q, k, v, *_: F.flash_prefill_contiguous(
                    q, k, v, kl, qo, return_lse=True),
                lambda q, k, v, *_: F.flash_prefill_contiguous_plain(
                    q, k, v, kl, qo, return_lse=True),
                4 * D * pairs, 2 * q_bytes + 2 * kv_bytes + row_bytes),
            "flash_prefill_bwd_dq": (
                lambda q, k, v, do, lse, delta, *_: F.flash_prefill_bwd_dq(
                    q, k, v, do, lse, delta, kl, qo),
                lambda q, k, v, do, lse, delta, *_:
                    F.flash_prefill_bwd_dq_plain(q, k, v, do, lse, delta, kl,
                                                 qo),
                6 * D * pairs, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
            "flash_prefill_bwd_dkv": (
                lambda q, k, v, do, lse, delta, *_: F.flash_prefill_bwd_dkv(
                    q, k, v, do, lse, delta, kl, qo),
                lambda q, k, v, do, lse, delta, *_:
                    F.flash_prefill_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  kl, qo),
                8 * D * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes)}
        it = 20
        lib = {}
        for form in ("gqa", "expanded"):
            exp = form == "expanded"
            f = time_ms(torch, lambda *a: lib_fwd(*a, exp), sets, it,
                        f"sdpa {form} forward D={D}")
            fb = time_ms(torch, lambda *a: lib_fwd_bwd(*a, exp), sets, it,
                         f"sdpa {form} forward+backward D={D}")
            lib[form] = (f, fb - f)
        rows = {}
        for name, (fn, plain, flops, nbytes) in kern_fns.items():
            side = 0 if name == "flash_prefill" else 1
            kern = time_ms(torch, fn, sets, it, f"{name} D={D}")
            pl = time_ms(torch, plain, sets, 3, f"{name} plain D={D}")
            b, by = bound(nbytes, flops)
            rows[name] = dict(
                ms=kern, plain_ms=pl, bound_ms=b, bound_by=by,
                library_ms=min(lib["gqa"][side], lib["expanded"][side]),
                library_gqa_ms=lib["gqa"][side],
                library_expanded_ms=lib["expanded"][side])
            log(f"[time] {name} [{B},{H},{S},{D}] n_kv={n_kv}: {kern:.4f} ms "
                f"(plain {pl:.4f}, SDPA{' backward' if side else ''} gqa "
                f"{lib['gqa'][side]:.4f} / expanded "
                f"{lib['expanded'][side]:.4f}, bound {b:.4f} by {by}) "
                f"({self.details['gpu']})")
        del sets
        return rows

    def time_training_kernels(self):
        """K7-K9 at one layer of the training step ([8,15,512,64] causal,
        f32 KV), at olmoe-1b-7b's head layout ([8,16,512,128], one kv head
        per query head) and at recurrentgemma-9b's over 8 x 512 tokens
        ([8,16,512,256] on one kv head), with `_time_flash`'s yardsticks;
        transpose_a at the step's dW shapes (K = 4,096), each beside its
        plain version, its library call and its bound."""
        torch = self.torch
        from repro_torch.kernels import posit_gemm as G
        shape = "one layer of the training step: [8,15,512,64] causal, f32 KV"
        self.details["flash_times_training"] = self._time_flash(
            8, 15, 5, 512, 64)
        for name, row in self.details["flash_times_training"].items():
            self.record(name, shape=shape + (
                "; library: the faster of SDPA's GQA and expanded-KV forms, "
                + ("its backward (dQ, dK, dV together) = forward+backward - "
                   "forward" if "bwd" in name else "forward")), **row)
        self.details["flash_times_d128_g1"] = self._time_flash(
            8, 16, 16, 512, 128)
        self.details["flash_times_d256_g16"] = self._time_flash(
            8, 16, 1, 512, 256)
        torch.cuda.empty_cache()

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
            b, by, ffma = tc_bound(nb, flops, gemm_products(None, None))
            splits = G.gemm_plan(M, N, K, ("f32", "f32"), True).splits
            rows.append({"M": M, "N": N, "K": K, "per_step": count,
                         "ms": kern, "plain_ms": pl, "library_ms": lib,
                         "bound_ms": b, "bound_by": by, "ffma_bound_ms": ffma,
                         "splits": splits,
                         "tflop_per_s": flops / kern / 1e9})
            log(f"[time] posit_gemm transpose_a {at} (split-K {splits}): "
                f"{kern:.4f} ms ({flops / kern / 1e9:.1f} TFLOP/s; plain "
                f"{pl:.4f}, torch.matmul(a.T, g) f32 {lib:.4f}, bound "
                f"{b:.4f} by {by}, FFMA bound {ffma:.4f})")
            for key, val in (("ms", kern), ("plain_ms", pl),
                             ("library_ms", lib), ("bytes", nb),
                             ("flops", flops)):
                total[key] += count * val
            del gsets
        self.details["transpose_a_shapes"] = rows
        b, by, ffma = tc_bound(total["bytes"], total["flops"],
                               gemm_products(None, None))
        self.details["transpose_a_ffma_bound_ms"] = ffma
        log(f"[time] posit_gemm transpose_a, one step's 225 dW GEMMs: "
            f"{total['ms']:.3f} ms (plain {total['plain_ms']:.3f}, "
            f"torch.matmul {total['library_ms']:.3f}, bound {b:.3f} by {by}, "
            f"FFMA bound {ffma:.3f}) ({self.details['gpu']})")
        self.record("posit_gemm_transpose_a",
                    shape="the dW GEMMs of one training step: 225 at K=4096 "
                          "(7 per layer x 32 + the tied table), f32; bound: "
                          "6 bf16 products per f32 product over the tensor "
                          "cores",
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
            self._repeat_same(f"quire GEMM K={K} N={N}", acc,
                              G.posit_gemm(a, b, **kw))
            want = G.posit_gemm_plain(a, b, **kw)
            af, bf = ref.decode_ref(a, cfg), ref.decode_ref(b, cfg)
            tol = 2 * K * 2.0 ** -24 * (af.abs() @ (bf.T if tb else bf).abs())
            diff = (acc - want).abs()
            worst = max(worst, float((diff / (tol + 1e-30)).max()))
            self.err("posit_gemm", diff.max())
            pos = G.posit_gemm(a, b, cfg_out=cfg, out_posit=True, **kw)
            self._repeat_same(f"quire GEMM K={K} N={N} posit out", pos,
                              G.posit_gemm(a, b, cfg_out=cfg, out_posit=True,
                                           **kw))
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
            b_ms, by, ffma = tc_bound(nbytes, 2.0 * 1024 * K * N,
                                      gemm_products(cfg, cfg))
            splits = G.gemm_plan(1024, N, K, ("posit", "posit")).splits
            grows.append({"M": 1024, "K": K, "N": N, "ms": kern,
                          "plain_ms": pl, "library_ms": libm,
                          "bound_ms": b_ms, "bound_by": by,
                          "ffma_bound_ms": ffma, "splits": splits})
            log(f"[time] posit_gemm p16 x p16 -> p16 M=1024 K={K} N={N} "
                f"(split-K {splits}): {kern:.4f} ms (plain {pl:.4f}, "
                f"torch.matmul on decoded f32 {libm:.4f}, bound {b_ms:.4f} by "
                f"{by}, FFMA bound {ffma:.4f})")
            for k, v in (("ms", kern), ("plain_ms", pl), ("library_ms", libm),
                         ("bytes", nbytes), ("flops", 2.0 * 1024 * K * N)):
                total[k] += v
        self.details["quire_gemm_timings"] = grows
        b_ms, by, ffma = tc_bound(total["bytes"], total["flops"],
                                  gemm_products(cfg, cfg))
        self.details["quire_gemm_ffma_bound_ms"] = ffma
        log(f"[time] quire GEMM, sum of the three: {total['ms']:.4f} ms "
            f"(plain {total['plain_ms']:.4f}, torch.matmul "
            f"{total['library_ms']:.4f}, bound {b_ms:.4f} by {by}, FFMA "
            f"bound {ffma:.4f}) ({self.details['gpu']})")
        self.record("posit_gemm", shape="quire GEMM p16 x p16 -> p16, M=1024, "
                    "sum of 960x960 + 960x2560 + 2560x960; bound: 4 bf16 "
                    "products per f32 product over the tensor cores",
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

        pp = ("posit", "posit")
        expect = {"elementwise": 4, "divide": 6, "posit_gemm": 4,
                  "posit_gemm_reduce": splitk_reduces([
                      (1024, 960, 960, pp, False, False),
                      (1024, 2560, 960, pp, False, False),
                      (1024, 960, 2560, pp, False, False),
                      (1024, 960, 960, pp, False, False)])}
        if any(plain.values()):
            raise AssertionError(f"plain versions ran on the arithmetic "
                                 f"path: {plain}")
        if {k: launches[k] for k in expect} != expect:
            raise AssertionError(f"arithmetic launch counts {launches} "
                                 f"differ from the path's {expect}")
        # pnp.asarray encodes a, b, c, A and the three W; nothing decodes
        # or round-trips
        codec = {"encode_block": 7, "decode_block": 0, "round_trip_block": 0}
        if {k: launches[k] for k in codec} != codec:
            raise AssertionError(f"arithmetic codec launches {launches} "
                                 f"differ from the path's {codec}")
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
    def serve(self, arch="smollm-360m", key="serving", long_prompts=0):
        """The serving main path of `arch` at full width from the port's
        seeded init, post-training quantized to posit16 (weights, KV and
        recurrent state), 16 requests (prompts 128..512, 32 new tokens,
        greedy) and `long_prompts` more of 2,176 tokens through
        PagedServingEngine(max_seqs=8, page_size=16, prefill_chunk=128),
        every counter zeroed just before the PTQ and read just after the
        drain; the launches must match the path's structure
        (`serving_launches`) and no plain version may run."""
        torch = self.torch
        import numpy as np
        from repro_torch import configs
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import grouped_gemm as GG
        from repro_torch.kernels import ops
        from repro_torch.models.transformer import init_params
        from repro_torch.quant.policy import PositPolicy
        from repro_torch.quant.ptq import quantize_for_serving
        from repro_torch.serving.engine import PagedServingEngine

        cfg = configs.get_config(arch, policy=PositPolicy(weights=P16_2,
                                                          kv_cache=P16_2))
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, seed=0, device=self.dev)
        rng = np.random.default_rng(1)
        lens = rng.integers(128, 513, 16)
        reqs = [(rng.integers(0, cfg.vocab, int(n)).astype(np.int32), 32)
                for n in lens]
        reqs += [(rng.integers(0, cfg.vocab, LONG_PROMPT).astype(np.int32),
                  32) for _ in range(long_prompts)]
        width = -(-(max(len(p) for p, _ in reqs) + 32) // 16)
        torch.cuda.synchronize()

        # ---- the counted run: PTQ + engine + drain ----
        ops.reset_counters()
        qparams = quantize_for_serving(params, P16_2)
        del params
        torch.cuda.empty_cache()
        eng = PagedServingEngine(qparams, cfg, max_seqs=8, page_size=16,
                                 prefill_chunk=128, table_width=width,
                                 device=self.dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        plain = ops.plain_counts()
        streamed = GG.posit_grouped_gemm.stream_launches
        # ---- end of the counted run ----

        stats = eng.stats()
        bad = [r for r in range(len(reqs))
               if r not in out or len(out[r]) != 32]
        if bad or stats["failed_nar"] or stats["completed"] != len(reqs):
            raise AssertionError(f"serving {arch}: requests {bad} "
                                 f"incomplete; stats {stats}")
        if any(plain.values()):
            raise AssertionError(f"serving {arch}: plain versions ran: "
                                 f"{plain}")
        pre, dec = stats["prefill_steps"], stats["decode_steps"]
        expect, ptq = serving_launches(cfg, pre, dec, gemm_weights(qparams))
        got = {k: launches[k] for k in expect}
        if got != expect or any(v for k, v in launches.items()
                                if k not in expect):
            raise AssertionError(f"serving {arch}: launch counts {launches} "
                                 f"differ from the path's structure {expect}")
        if cfg.moe is not None:
            # every decode step (at most 8 x top-k rows) streams its three
            # grouped GEMMs a layer; prefill steps stream below 128 tokens
            lo, hi = 3 * cfg.n_layers * dec, 3 * cfg.n_layers * (dec + pre)
            if not lo <= streamed <= hi:
                raise AssertionError(f"serving {arch}: {streamed} grouped "
                                     f"GEMMs in the decode form, outside "
                                     f"[{lo}, {hi}]")
            log(f"[serve] {arch}: {streamed} of {launches['grouped_gemm']} "
                f"grouped GEMMs in the decode form (every decode step's "
                f"{lo}; the rest are prefill steps')")

        def nbytes(tree):
            if isinstance(tree, dict):
                return sum(nbytes(v) for v in tree.values())
            if isinstance(tree, (list, tuple)):
                return sum(nbytes(v) for v in tree)
            t = getattr(tree, "bits", tree)
            return t.numel() * t.element_size()

        if long_prompts and not stats["expired_page_frees"]:
            raise AssertionError(f"serving {arch}: prompts past the window "
                                 f"freed no expired page; stats {stats}")
        steps = pre + dec
        n_tok = sum(len(v) for v in out.values())
        d_ms = np.asarray(eng.step_times["decode"]) * 1e3
        p_ms = np.asarray(eng.step_times["prefill"]) * 1e3
        ttft = np.asarray(list(eng.ttft_s.values())) * 1e3
        serving = {
            "requests": len(reqs), "tokens": n_tok, "drain_s": drain_s,
            "tok_per_s": n_tok / drain_s, "ttft_mean_ms": float(ttft.mean()),
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "decode_step_p50_ms": float(np.percentile(d_ms, 50)),
            "decode_step_p90_ms": float(np.percentile(d_ms, 90)),
            "prefill_step_p50_ms": float(np.percentile(p_ms, 50)),
            "prefill_steps": pre, "decode_steps": dec,
            "preempted": stats["preempted"],
            "weights_bytes": nbytes(qparams), "params": cfg.param_count(),
            "pool_bytes": nbytes(eng.pages),
            "state_bytes": nbytes([layer for layer in eng.pages["layers"]
                                   if "k_pages" not in layer]),
            "expired_page_frees": stats["expired_page_frees"],
            "table_width": width, "launches": got,
            "launches_per_step": {k: (v - ptq.get(k, 0)) / steps
                                  for k, v in got.items()},
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "prompt_lens": [int(n) for n in lens],
        }
        self.details[key] = serving
        card = self.details["gpu"]
        log(f"[serve] {cfg.name} full width ({cfg.param_count()} params, "
            f"{cfg.n_layers} layers), p16 weights + KV + state, {len(reqs)} "
            f"requests (prompts 128..512"
            f"{f' and {long_prompts} x {LONG_PROMPT}' if long_prompts else ''}"
            f", max_new 32, greedy), max_seqs=8, page=16, chunk=128 on "
            f"{card}")
        log(f"[serve] {n_tok} tokens in {drain_s:.3f} s = "
            f"{serving['tok_per_s']:.1f} tok/s; mean TTFT "
            f"{serving['ttft_mean_ms']:.1f} ms; decode step p50 "
            f"{serving['decode_step_p50_ms']:.3f} ms; prefill step p50 "
            f"{serving['prefill_step_p50_ms']:.2f} ms; {pre} prefill + {dec} "
            f"decode steps ({card})")
        log(f"[serve] weights {serving['weights_bytes'] / 1e6:.1f} MB, pool "
            f"{serving['pool_bytes'] / 1e6:.1f} MB (state "
            f"{serving['state_bytes'] / 1e6:.3f} MB), expired page frees "
            f"{serving['expired_page_frees']}, peak "
            f"{serving['peak_bytes'] / 2 ** 30:.2f} GiB; launches per step "
            f"{json.dumps(serving['launches_per_step'])} ({card})")
        return qparams, cfg, reqs

    def trace_decode(self, qparams, cfg, reqs, key="decode_trace"):
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
                     k: v[0] / steps / 1e3 for k, v in top},
                 "codec_kernels_per_step": {
                     k: {"ms": by_name.get(k, [0.0, 0])[0] / steps / 1e3,
                         "launches": by_name.get(k, [0.0, 0])[1] / steps}
                     for k in CODEC_KERNEL_SYMBOLS}}
        self.details[key] = trace
        if not busy_us:
            log("[trace] the profiler saw no device time: busy share not "
                "measured")
            return
        log(f"[trace] {cfg.name} decode steps under torch.profiler: wall "
            f"{trace['wall_ms_per_step']:.2f} ms/step, device busy "
            f"{trace['device_busy_ms_per_step']:.2f} ms/step (share "
            f"{trace['device_busy_share']:.3f}; of the "
            f"{trace['unprofiled_wall_ms_per_step']:.2f} ms unprofiled step "
            f"just before: {trace['device_busy_share_unprofiled']:.3f}), "
            f"{trace['device_launches_per_step']:.0f} device kernels/step "
            f"({self.details['gpu']})")
        for k, v in trace["top_kernels_ms_per_step"].items():
            log(f"[trace]   {v:8.3f} ms/step  {k}")
        log("[trace]   K1 a step: " + ", ".join(
            f"{k} {v['ms']:.3f} ms in {v['launches']:.0f}"
            for k, v in trace["codec_kernels_per_step"].items()))

    def trace_prefill(self, qparams, cfg, reqs, key):
        """One prefill step of 8 x 128 prompt tokens outside the counted
        run: 8 slots given 512-token prompts, the first chunk a warm step,
        the second timed on the host clock, the third under torch.profiler.
        Reports its wall time, device time by kernel and busy share, and
        the scans' (K12, K13) share of the device time."""
        torch = self.torch
        import numpy as np
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.serving.engine import PagedServingEngine
        eng = PagedServingEngine(qparams, cfg, max_seqs=8, page_size=16,
                                 prefill_chunk=128,
                                 table_width=-(-(512 + 4) // 16),
                                 device="cuda")
        long = [p for p, _ in reqs if len(p) >= 512][:8]
        long += [p for p, _ in reqs if len(p) < 512][:8 - len(long)]
        for prompt in long:
            eng.submit(np.resize(prompt, 512), 4)
        eng.step()                                # the warm prefill step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if eng.counters["prefill_steps"] != 3:
            raise AssertionError(f"trace_prefill {cfg.name}: "
                                 f"{eng.counters['prefill_steps']} prefill "
                                 f"steps of 3")
        by_name = device_time_by_kernel(torch, prof)
        busy_ms = sum(v[0] for v in by_name.values()) / 1e3
        scans = {k: v[0] / 1e3 for k, v in by_name.items()
                 if k in ("wkv_scan_kernel", "rglru_scan_kernel")}
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        trace = {"rows": 8 * 128, "wall_ms": wall_ms,
                 "unprofiled_wall_ms": plain_wall_ms,
                 "device_busy_ms": busy_ms,
                 "device_busy_share_unprofiled":
                     busy_ms / plain_wall_ms if busy_ms else None,
                 "device_launches": sum(v[1] for v in by_name.values()),
                 "scan_ms": scans,
                 "top_kernels_ms": {k: v[0] / 1e3 for k, v in top},
                 "top_kernels_launches": {k: v[1] for k, v in top}}
        self.details[key] = trace
        if not busy_ms:
            log("[trace] the profiler saw no device time: prefill breakdown "
                "not measured")
            return
        log(f"[trace] {cfg.name} prefill step (8 x 128 tokens) under "
            f"torch.profiler: wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms:.2f} ms (of the {plain_wall_ms:.2f} ms unprofiled "
            f"step just before: {trace['device_busy_share_unprofiled']:.3f})"
            f", {trace['device_launches']} device kernels; scans "
            f"{json.dumps(scans)} ({self.details['gpu']})")
        for k, v in trace["top_kernels_ms"].items():
            log(f"[trace]   {v:8.3f} ms  {trace['top_kernels_launches'][k]:5d}"
                f" x  {k}")

    def prefill_traces(self, archs=("rwkv6-3b", "recurrentgemma-9b")):
        """`trace_prefill` alone for each of `archs` at full width, from
        the port's seeded init post-training quantized to posit16, without
        the counted drain."""
        torch = self.torch
        import numpy as np
        from repro_torch import configs
        from repro_torch.core.types import P16_2
        from repro_torch.models.transformer import init_params
        from repro_torch.quant.policy import PositPolicy
        from repro_torch.quant.ptq import quantize_for_serving
        for arch in archs:
            cfg = configs.get_config(arch, policy=PositPolicy(
                weights=P16_2, kv_cache=P16_2))
            params = init_params(cfg, seed=0, device=self.dev)
            qparams = quantize_for_serving(params, P16_2)
            del params
            torch.cuda.empty_cache()
            rng = np.random.default_rng(1)
            reqs = [(rng.integers(0, cfg.vocab, 512).astype(np.int32), 4)
                    for _ in range(8)]
            self.trace_prefill(qparams, cfg, reqs,
                               key=f"{arch}_prefill_trace")
            del qparams
            torch.cuda.empty_cache()

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

    def check_smoke_drain(self, arch="smollm-360m"):
        """A smoke-size drain of `arch` with preemption on the card
        (kernels) and on the CPU (plain versions), same weights: identical
        greedy tokens.  A model with no attention layer takes no pages, so
        it is preempted by hand (the youngest sequence, after 4 steps)."""
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
            cfg = configs.get_smoke(arch, policy=pol)
            outs = []
            for dev in ("cuda", "cpu"):
                params = init_params(cfg, seed=0, device="cpu")
                params = self._to(params, dev)
                if pcfg is not None:
                    params = quantize_for_serving(params, pcfg)
                eng = PagedServingEngine(params, cfg, device=dev, **kw)
                for prompt, n in reqs:
                    eng.submit(prompt, n)
                if not eng.layout.needs_pages:
                    for _ in range(4):
                        eng.step()
                    if not eng._preempt(exclude=0):
                        raise AssertionError("smoke drain: nothing to "
                                             "preempt")
                outs.append((eng.run(), eng.counters["preempted"]))
            (a, pa), (b, pb) = outs
            same = sorted(a) == sorted(b) and all(
                np.array_equal(a[r], b[r]) for r in a)
            log(f"[check] smoke drain {arch} {pcfg or 'float'}: card vs CPU "
                f"greedy tokens identical: {same} (preempted {pa}/{pb})")
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

    def train_full(self, arch="smollm-360m", legs=("p16", "f32"),
                   n_layers=None, key="training"):
        """The training main path: `train_loop` on `arch` at full width
        (n_layers: a cut depth), 8 steps of 8 x 512 tokens per leg, with
        posit16 STE weights ("p16") and PositPolicy() ("f32"), same init
        and batches (the port's run of the p16-vs-f32 loss-gap
        experiment), counters zeroed just before each leg and read just
        after, the launches held to `training_launches`; after the p16
        leg, one more step under torch.profiler for the busy share."""
        import numpy as np
        from repro_torch import configs
        from repro_torch.core.types import P16_2
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.kernels import grouped_gemm as GG
        from repro_torch.optim.adamw import OptConfig
        from repro_torch.quant.policy import PositPolicy
        steps = TRAIN_STEPS
        # launch/train.py's settings for --steps 8
        opt = OptConfig(lr_peak=3e-4, warmup_steps=min(100, steps // 10 + 1),
                        total_steps=steps)
        out = {}
        for name in legs:
            pol = PositPolicy(weights=P16_2) if name == "p16" else \
                PositPolicy()
            cfg = configs.get_config(arch, policy=pol)
            if n_layers is not None:
                cfg = dataclasses.replace(cfg, n_layers=n_layers)
            data = DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=8)
            params, hist, launches, plain, peak, wall = self._train_leg(
                cfg, steps, data, opt)
            if cfg.moe is not None and \
                    GG.posit_grouped_gemm.stream_launches:
                raise AssertionError(f"{arch} {name}: training ran grouped "
                                     f"GEMMs in the decode form")
            losses = [h["loss"] for h in hist]
            aux = [h["aux"] for h in hist]
            if not all(math.isfinite(x) for x in losses + aux):
                raise AssertionError(f"{arch} {name}: non-finite loss "
                                     f"{losses}")
            if any(plain.values()):
                raise AssertionError(f"{arch} {name}: plain versions ran on "
                                     f"the training path: {plain}")
            expect = training_launches(
                cfg, steps, name == "p16", gemm_weights(params),
                data.global_batch * data.seq_len)
            got = {k: launches[k] for k in expect}
            if got != expect or any(v for k, v in launches.items()
                                    if k not in expect):
                raise AssertionError(f"{arch} {name}: launch counts "
                                     f"{launches} differ from the path's "
                                     f"{expect}")
            step_s = [1.0 / h["steps_per_s"] for h in hist]
            p50 = float(np.percentile(step_s[1:], 50))
            tokens = data.global_batch * data.seq_len
            out[name] = {
                "layers": cfg.n_layers, "losses": losses, "aux": aux,
                "step_s": step_s, "step_p50_s": p50,
                "tokens_per_s": tokens / p50, "peak_bytes": peak,
                "wall_s": wall, "launches": got,
                "launches_per_step": {k: v // steps for k, v in got.items()},
                "plain_calls": plain, "params": cfg.param_count()}
            log(f"[train] {cfg.name} {name} leg, full width, depth "
                f"{cfg.n_layers} ({cfg.param_count()} params), 8 x 512 "
                f"tokens/step: losses {[round(x, 4) for x in losses]}"
                + (f", aux {[round(x, 4) for x in aux]}" if cfg.moe else "")
                + f"; step p50 {p50:.3f} s ({tokens / p50:.0f} tok/s; first "
                f"step {step_s[0]:.3f} s); peak {peak / 2 ** 30:.2f} GiB; "
                f"{wall:.1f} s wall ({self.details['gpu']})")
            log(f"[train] {name} launches per step "
                f"{json.dumps(out[name]['launches_per_step'])}; plain "
                f"calls {json.dumps(plain)}")
            if name == "p16":
                # before the f32 leg, so that its peak holds no p16 params
                out[name]["trace"] = self._profile_step(cfg, params, opt,
                                                        data, p50)
            del params
        if "f32" in out:
            out["gap"] = [a - b for a, b in zip(out["p16"]["losses"],
                                                out["f32"]["losses"])]
            log(f"[train] p16 - f32 loss gap per step: "
                f"{[round(x, 5) for x in out['gap']]}")
        self.details[key] = out
        return out

    def _profile_step(self, cfg, params, opt, data, step_p50_s):
        """One more training step (fresh AdamW state, outside the counted
        runs, after one unprofiled warm step) under torch.profiler: device
        time by kernel (the top 8, and the flash kernels K7-K9 with their
        launch counts whatever their rank) and the busy share, over the
        profiled step's own wall time (a lower bound: the profiler adds
        host cost) and over the unprofiled leg's step p50."""
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
                 "top_kernels_ms": {k: v[0] / 1e3 for k, v in top},
                 "flash_kernels": {
                     k: {"ms": by_name.get(k, [0.0, 0])[0] / 1e3,
                         "launches": by_name.get(k, [0.0, 0])[1]}
                     for k in FLASH_KERNEL_SYMBOLS},
                 "codec_kernels": {
                     k: {"ms": by_name.get(k, [0.0, 0])[0] / 1e3,
                         "launches": by_name.get(k, [0.0, 0])[1]}
                     for k in CODEC_KERNEL_SYMBOLS}}
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
        for k, v in trace["flash_kernels"].items():
            log(f"[train]   flash: {v['ms']:9.3f} ms in {v['launches']} "
                f"launches  {k}")
        for k, v in trace["codec_kernels"].items():
            log(f"[train]   K1: {v['ms']:9.3f} ms in {v['launches']} "
                f"launches  {k}")
        k1_ms = sum(v["ms"] for v in trace["codec_kernels"].values())
        log(f"[train]   K1 in all: {k1_ms:.3f} ms a step")
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

    # ---- phase 6: the MoE path (olmoe-1b-7b) -------------------------------
    def _moe_offsets(self, T):
        """Offsets [E+1] int32 of T tokens, each routed to top-k distinct
        experts drawn at random (a random router's routing)."""
        torch = self.torch
        E, k = MOE_E, MOE_K
        r = torch.rand((T, E), generator=self.gen, device=self.dev)
        keys, _ = torch.sort(r.argsort(dim=-1)[:, :k].reshape(-1))
        return torch.searchsorted(
            keys, torch.arange(E + 1, device=self.dev)).to(torch.int32)

    def _offsets_of(self, sizes):
        torch = self.torch
        return torch.tensor([0] + list(itertools.accumulate(sizes)),
                            dtype=torch.int32, device=self.dev)

    def _grouped_form(self, label, S, N, K, E, elem_bytes, tb, before):
        """The wrapper's decode-form count moved by the launches since
        `before` exactly as the plan's form says: posit weights below 16
        rows a group (every decode step) stream, the rest run the tiled
        form."""
        from repro_torch.kernels import grouped_gemm as GG
        plan = GG.grouped_plan(S, N, K, E, elem_bytes, tb)
        want = "stream" if elem_bytes != 4 and S < GG.STREAM_ROWS * E \
            else "mma"
        moved = GG.posit_grouped_gemm.stream_launches - before
        if plan.form != want or moved != (2 if want == "stream" else 0):
            raise AssertionError(f"grouped_gemm {label}: form {plan.form} "
                                 f"(want {want}), {moved} decode-form "
                                 f"launches of 2")
        return plan.form

    def _check_grouped(self, label, S, K, N, off, cfg, transpose_b):
        """K10 against its plain version: w stored [E, K, N] (posit of cfg,
        or f32), x [S, K] (or [S, N] with transpose_b, the dX form), within
        the f32 dot-product bound 2 Kc 2^-24 (|x| |w_g|) over the
        contraction Kc, plus for f32 weights the declared 2^-22 (|x| |w_g|)
        of the tiled form's three dropped piece products; rows outside
        every group exactly 0 on both sides; launched twice, bit-identical,
        in the form its plan names."""
        from repro_torch.kernels import grouped_gemm as GG
        from repro_torch.kernels import ref
        E = off.shape[0] - 1
        w = self.randn(E, K, N, scale=K ** -0.5)
        if cfg is not None:
            w = ref.encode_ref(w, cfg)
        kc = N if transpose_b else K
        nout = K if transpose_b else N
        x = self.randn(S, kc)
        before = GG.posit_grouped_gemm.stream_launches
        got = GG.posit_grouped_gemm(x, w, off, cfg, transpose_b=transpose_b)
        self._repeat_same(f"grouped_gemm {label}", got, GG.posit_grouped_gemm(
            x, w, off, cfg, transpose_b=transpose_b))
        form = self._grouped_form(label, S, nout, kc, E, w.element_size(),
                                  transpose_b, before)
        want = GG.posit_grouped_gemm_plain(x, w, off, cfg, transpose_b)
        s = ref.grouped_matmul_ref(x.abs(), ref.values(w, cfg).abs(), off,
                                   transpose_b=transpose_b)
        tol = (2 * kc * 2.0 ** -24 + (2.0 ** -22 if cfg is None else 0.0)) * s
        _, inb = ref.grouped_row_ids(off, S)
        out_rows = int((~inb).sum())
        if out_rows and not (bool((got[~inb] == 0).all())
                             and bool((want[~inb] == 0).all())):
            raise AssertionError(f"grouped_gemm {label}: rows outside every "
                                 f"group are not 0")
        return self._within("grouped_gemm", f"{label} {cfg or 'f32'} "
                            f"transpose_b={transpose_b} {form} form "
                            f"({out_rows} rows outside groups, repeat "
                            f"bit-identical)", got, want, tol)

    def _check_grouped_dw(self, label, S, K, N, off):
        """K11 against its plain version within 2 n_e 2^-24 (|x|^T |g|) per
        group of n_e rows plus the declared 2^-22 (|x|^T |g|) of the f32 x
        f32 pieces; an empty group exactly 0 on both sides; launched twice,
        bit-identical."""
        from repro_torch.kernels import grouped_gemm as GG
        from repro_torch.kernels import ref
        x, g = self.randn(S, K), self.randn(S, N)
        got = GG.posit_grouped_gemm_dw(x, g, off)
        self._repeat_same(f"grouped_gemm_dw {label}", got,
                          GG.posit_grouped_gemm_dw(x, g, off))
        want = GG.posit_grouped_gemm_dw_plain(x, g, off)
        n_e = (off[1:] - off[:-1]).clamp_min(0).float()
        tol = (2 * n_e[:, None, None] * 2.0 ** -24 + 2.0 ** -22) * \
            ref.grouped_matmul_dw_ref(x.abs(), g.abs(), off)
        empty = n_e == 0
        if bool(empty.any()) and not (bool((got[empty] == 0).all())
                                      and bool((want[empty] == 0).all())):
            raise AssertionError(f"grouped_gemm_dw {label}: empty groups "
                                 f"are not 0")
        return self._within("grouped_gemm_dw", f"{label} ({int(empty.sum())}"
                            f" empty groups, repeat bit-identical)", got,
                            want, tol)

    def check_grouped_decode(self):
        """Every posit16 and posit8 pattern (P16_2, P16_1, P8_2, P8_0)
        through K = 1 grouped GEMMs with x = 1, bit for bit against
        ref.decode_ref (NaR -> NaN): in the decode form (one row of one
        group, and one group of 8 rows: the 4- and 8-wide passes) and the
        tiled form (16 rows), both orientations."""
        torch = self.torch
        from repro_torch.core.types import P8_0, P8_2, P16_1, P16_2
        from repro_torch.kernels import grouped_gemm as GG
        from repro_torch.kernels import ref
        for cfg in (P16_2, P16_1, P8_2, P8_0):
            dt = getattr(torch, cfg.storage_dtype_name)
            pats = torch.arange(-(1 << (cfg.n - 1)), 1 << (cfg.n - 1),
                                device=self.dev, dtype=torch.int32).to(dt)
            want = ref.decode_ref(pats, cfg)
            fin = torch.isfinite(want)
            for S, tb in itertools.product((1, 8, 16), (False, True)):
                x = torch.ones((S, 1), device=self.dev)
                w = pats[None, None, :] if not tb else pats[None, :, None]
                off = self._offsets_of([S])
                before = GG.posit_grouped_gemm.stream_launches
                label = f"decode {cfg} S={S} tb={tb}"
                got = GG.posit_grouped_gemm(x, w, off, cfg, transpose_b=tb)
                self._repeat_same(f"grouped_gemm {label}", got,
                                  GG.posit_grouped_gemm(x, w, off, cfg,
                                                        transpose_b=tb))
                self._grouped_form(label, S, pats.numel(), 1, 1,
                                   w.element_size(), tb, before)
                bad = int((got[:, fin].view(torch.int32)
                           != want[fin].view(torch.int32)).sum())
                bad += int((~torch.isnan(got[:, ~fin])).sum())
                if bad:
                    raise AssertionError(f"grouped_gemm {label}: {bad} "
                                         f"values differ from decode_ref")
            log(f"[grouped_gemm] decode {cfg}: all {pats.numel()} patterns, "
                f"decode form (1 and 8 rows) and tiled form (16 rows), both "
                f"orientations, bit-exact (NaR -> NaN)")

    def check_moe_kernels(self):
        """(a) K10 with posit16, posit8 and f32 experts, with and without
        transpose_b, and K11, at olmoe-1b-7b's widths (64 experts, 2048 x
        1024 up/gate and 1024 x 2048 down tables) and the path's row counts
        (a decode step's 8 x 8 pairs, a prefill step's 1,024 x 8, a training
        step's 4,096 x 8, randomly routed); then the edge layouts at 500
        rows (the decode form for posit experts) and at 2,000 (the tiled
        form): many empty groups, one group holding every row, boundaries
        inside a 64-row tile, and rows past offsets[E]; every launch
        repeated bit-identical and in its plan's form."""
        from repro_torch.core.types import P8_2, P16_2
        self.check_grouped_decode()
        worst = 0.0
        for tag, T in (("decode", 8), ("prefill", 1024), ("training", 4096)):
            off = self._moe_offsets(T)
            S = T * MOE_K
            for name, K, N in MOE_SHAPES:
                for cfg in (P16_2, P8_2, None):
                    for tb in (False, True):
                        worst = max(worst, self._check_grouped(
                            f"{tag} S={S} {name}", S, K, N, off, cfg, tb))
                if tag != "decode":
                    worst = max(worst, self._check_grouped_dw(
                        f"{tag} S={S} {name}", S, K, N, off))
        E = MOE_E
        chunks = [1, 63, 65, 3, 127, 0, 70, 2, 33, 64, 1]
        layouts = {500: {
            "many empty groups": [0] * 10 + [7] + [0] * 30 + [200, 0, 90] +
                                 [0] * 19 + [203],
            "one group holds every row": [0] * 17 + [500] + [0] * (E - 18),
            "boundaries inside 64-row chunks":
                chunks + [0] * (E - len(chunks)),
            "rows past offsets[E]": [3] * (E - 1) + [0],
        }, 2000: {
            "many empty groups": [0] * 10 + [7] + [0] * 30 + [800, 0, 360] +
                                 [0] * 19 + [833],
            "one group holds every row": [0] * 17 + [2000] + [0] * (E - 18),
            "boundaries inside 64-row tiles":
                chunks + [0] * (E - len(chunks) - 1) + [1000],
            "rows past offsets[E]": [24] * (E - 1) + [0],
        }}
        _, K, N = MOE_SHAPES[0]                 # the up/gate table
        for S, edges in layouts.items():
            for label, sizes in edges.items():
                off = self._offsets_of(sizes)
                for cfg in (P16_2, None):
                    for tb in (False, True):
                        worst = max(worst, self._check_grouped(
                            f"edge S={S}: {label}", S, K, N, off, cfg, tb))
                worst = max(worst, self._check_grouped_dw(
                    f"edge S={S}: {label}", S, K, N, off))
        self.details["moe_kernels_worst_err_over_bound"] = worst

    def time_moe_kernels(self, plain=True):
        """(b) K10 and K11 at the path's shapes, beside the plain versions
        (unless `plain` is False), the bound and a library yardstick: no
        single PyTorch call computes an f32 grouped product, so the
        yardstick is one torch.matmul per non-empty group on the decoded
        f32 tables (E calls), summed.  The bound at decode is bytes (the
        active experts' posit16 tables, x and out); elsewhere the tiled
        form's bf16 products (6 per f32 product: f32 x posit16, and f32 x
        f32 with three dropped) over 989 TFLOP/s, with the FFMA bound of
        2 S K N beside it."""
        torch = self.torch
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import grouped_gemm as GG
        from repro_torch.kernels import ref
        rows = []
        E = MOE_E
        for tag, T, cfg in (("decode", 8, P16_2), ("prefill", 1024, P16_2),
                            ("training", 4096, None)):
            off = self._moe_offsets(T)
            bounds = [(g, a, b) for g, (a, b) in enumerate(
                ref._group_bounds(off, T * MOE_K)) if b > a]
            active = len(bounds)
            S = T * MOE_K
            esize = 4 if cfg is None else 2
            forms = [("forward", False, "grouped_gemm")]
            if tag == "training":
                forms += [("dX (transpose_b)", True, "grouped_gemm"),
                          ("dW", None, "grouped_gemm_dw")]
            for name, K, N in MOE_SHAPES:
                ws = [self.randn(E, K, N, scale=K ** -0.5) for _ in range(2)]
                if cfg is not None:
                    ws = [ref.encode_ref(w, cfg) for w in ws]
                wfs = [ref.values(w, cfg) for w in ws]
                for form, tb, kern_name in forms:
                    kc, nout = (N, K) if tb else (K, N)
                    x = self.randn(S, kc)
                    at = f"{tag} S={S} {name} {form}"
                    plain_ms = None
                    if tb is None:                     # K11: dW of the table
                        g = self.randn(S, N)
                        xs = [(x, g), (self.randn(S, K), self.randn(S, N))]
                        kern = time_ms(torch, lambda a, b: GG.
                                       posit_grouped_gemm_dw(a, b, off), xs,
                                       20, f"grouped_gemm_dw {at}")
                        if plain:
                            plain_ms = time_ms(
                                torch, lambda a, b: GG.
                                posit_grouped_gemm_dw_plain(a, b, off), xs,
                                3, f"grouped_gemm_dw_plain {at}")
                        lib = time_ms(torch, lambda a, b: [
                            torch.matmul(a[s:t].T, b[s:t])
                            for _, s, t in bounds], xs, 5,
                            f"torch.matmul x E {at}")
                        nbytes = 4 * (S * K + S * N + E * K * N)
                        # an older tree (--src) has FFMA forms, no plan
                        kform = ("mma" if hasattr(GG, "grouped_plan")
                                 else "ffma")
                    else:
                        sets = [(w, wf) for w, wf in zip(ws, wfs)]
                        kern = time_ms(torch, lambda w, wf: GG.
                                       posit_grouped_gemm(x, w, off, cfg,
                                                          transpose_b=tb),
                                       sets, 20, f"grouped_gemm {at}")
                        if plain:
                            plain_ms = time_ms(
                                torch, lambda w, wf: GG.
                                posit_grouped_gemm_plain(x, w, off, cfg, tb),
                                sets, 3, f"grouped_gemm_plain {at}")
                        lib = time_ms(torch, lambda w, wf: [
                            torch.matmul(x[s:t], wf[e].T if tb else wf[e])
                            for e, s, t in bounds], sets, 5,
                            f"torch.matmul x E {at}")
                        nbytes = 4 * S * kc + active * K * N * esize \
                            + 4 * S * nout
                        kform = (GG.grouped_plan(S, nout, kc, E, esize,
                                                 tb).form
                                 if hasattr(GG, "grouped_plan") else "ffma")
                    flops = 2.0 * S * K * N
                    if tag == "decode":
                        b, by = bound(nbytes, flops)
                        ffma = b
                    else:
                        b, by, ffma = tc_bound(nbytes, flops, 6)
                    rows.append({"use": tag, "table": name, "form": form,
                                 "kernel": kern_name, "kernel_form": kform,
                                 "S": S, "K": K, "N": N,
                                 "active_experts": active,
                                 "weights": str(cfg or "f32"), "ms": kern,
                                 "plain_ms": plain_ms, "library_ms": lib,
                                 "bound_ms": b, "bound_by": by,
                                 "ffma_bound_ms": ffma,
                                 "tflop_per_s": flops / kern / 1e9})
                    pl = f"{plain_ms:.4f}" if plain_ms is not None \
                        else "not timed"
                    log(f"[time] {kern_name} {at} ({cfg or 'f32'}, {active} "
                        f"active experts, {kform} form): {kern:.4f} ms "
                        f"({flops / kern / 1e9:.1f} TFLOP/s; plain {pl}, "
                        f"torch.matmul x {active} {lib:.4f}, bound {b:.4f} "
                        f"by {by}, FFMA bound {ffma:.4f})")
                del ws, wfs
        self.details["moe_kernel_shapes"] = rows

        def total(pred, per):
            """Sum of `per[table] x row` over the rows matching pred."""
            acc = {"ms": 0.0, "plain_ms": 0.0 if plain else None,
                   "library_ms": 0.0, "bound_ms": 0.0, "ffma_bound_ms": 0.0}
            for r in rows:
                if pred(r):
                    for key in acc:
                        if acc[key] is not None:
                            acc[key] += per[r["table"]] * r[key]
            return acc

        step = total(lambda r: r["use"] == "decode",
                     {"up/gate": 2 * 16, "down": 16})
        dw = total(lambda r: r["kernel"] == "grouped_gemm_dw",
                   {"up/gate": 2, "down": 1})
        self.details["moe_kernel_totals"] = {"decode_step": step,
                                             "dw_layer": dw}
        log(f"[time] grouped_gemm olmoe decode step (48 GEMMs): "
            f"{step['ms']:.3f} ms, torch.matmul {step['library_ms']:.3f}, "
            f"bound {step['bound_ms']:.3f}; one layer's three dW: "
            f"{dw['ms']:.3f} ms, torch.matmul {dw['library_ms']:.3f}, "
            f"bound {dw['bound_ms']:.3f} (FFMA {dw['ffma_bound_ms']:.3f})")
        self.record("grouped_gemm",
                    shape="one decode step of olmoe-1b-7b: 48 grouped GEMMs "
                          "(16 layers x up, gate, down), 64 rows over 64 "
                          "experts, p16 experts, cold; bound by bytes, summed "
                          "per GEMM; library: torch.matmul per non-empty "
                          "group on f32 tables", bound_by="bytes",
                    **{k: v for k, v in step.items() if k != "ffma_bound_ms"})
        self.record("grouped_gemm_dw",
                    shape="one training layer's three expert dW (S=32,768 "
                          "rows, 8 x 512 tokens x top-8); bound by the "
                          "tensor cores' bf16 products (6 per f32 product), "
                          "summed; library: torch.matmul(x.T, g) per "
                          "non-empty group", bound_by="operations",
                    **{k: v for k, v in dw.items() if k != "ffma_bound_ms"})

    @contextlib.contextmanager
    def _recording_routes(self):
        """Record every MoE routing decision made inside the block: the
        router's input and weights, the softmax, the top-k ids and the
        capacity mask, per `moe._route` call, on the host."""
        from repro_torch.models import moe
        orig, calls = moe._route, []

        def recording(xt, p, **kw):
            out = orig(xt, p, **kw)
            probs, gate_idx, _, _, keep, _ = out
            calls.append({"x": xt.detach().float().cpu(),
                          "router": p["router"].detach().float().cpu(),
                          "probs": probs.detach().cpu(),
                          "idx": gate_idx.cpu(), "keep": keep.cpu()})
            return out

        moe._route = recording
        try:
            yield calls
        finally:
            moe._route = orig

    def _route_flips(self, card, cpu, wcfg):
        """Tokens whose top-k expert sets differ between the card's and the
        CPU's routing of the same call.  A flip is excused when, for every
        swapped pair (e_in chosen by the CPU only, e_out by the card only),
        the CPU's logit margin l_in - l_out lies within the router's f32
        bound: 2 d 2^-24 (|x| . |w_e|) per logit for the two summation
        orders, plus |x_card - x_cpu| . |w_e| for the input the layer
        received, for both experts.  Returns (flips: per flipped token the
        CPU's p_k - p_k+1, the worst margin over its bound and whether it
        is excused; per-call masks [T] of the flipped tokens)."""
        from repro_torch.quant.policy import posit_cast
        flips, masks = [], []
        for i, (c, h) in enumerate(zip(card, cpu)):
            E = h["probs"].shape[-1]
            k = h["idx"].shape[-1]
            ic = c["idx"].reshape(-1, k)
            ih = h["idx"].reshape(-1, k)
            diff = (ic.sort(-1).values != ih.sort(-1).values).any(-1)
            masks.append(diff)
            if not bool(diff.any()):
                continue
            d = h["x"].shape[-1]
            xh, xc = h["x"].reshape(-1, d), c["x"].reshape(-1, d)
            w = h["router"]
            if wcfg is not None:
                w = posit_cast(w, wcfg)
            lp = h["probs"].reshape(-1, E).double().log()
            for t in diff.nonzero().flatten().tolist():
                eb = (2 * d * 2.0 ** -24 * (xh[t].abs() @ w.abs())
                      + (xc[t] - xh[t]).abs() @ w.abs()).double()
                cin = set(ih[t].tolist()) - set(ic[t].tolist())
                cout = set(ic[t].tolist()) - set(ih[t].tolist())
                pairs = [(float(lp[t, a] - lp[t, b]), float(eb[a] + eb[b]))
                         for a in cin for b in cout]
                ps = lp[t].exp().sort(descending=True).values
                flips.append({
                    "call": i, "token": t,
                    "prob_margin": float(ps[k - 1] - ps[k]),
                    "worst_margin_over_bound": max(m / bd for m, bd in pairs),
                    "excused": all(m <= bd for m, bd in pairs)})
        return flips, masks

    def check_moe_logits(self):
        """(d) Card vs CPU at full width, depth 2 (the 16-layer f32 model
        would need 27.3 GB on the CPU side): the same posit16 PTQ weights, a
        4 x 32-token paged prefill and one decode step, the kernels on the
        card and the plain versions on the CPU.  Route flips are reported
        and must be excused by the router's f32 bound; logits are compared
        over the positions no flip touched (a flip in layer 0 touches its
        sequence's later positions through attention)."""
        torch = self.torch
        import numpy as np
        from repro_torch import configs
        from repro_torch.core.types import P16_2
        from repro_torch.models.transformer import (assemble_paged_caches,
                                                    extract_paged_pages,
                                                    forward, init_params,
                                                    init_paged_pages)
        from repro_torch.quant.policy import PositPolicy
        from repro_torch.quant.ptq import quantize_for_serving
        cfg = dataclasses.replace(configs.get_config(
            "olmoe-1b-7b", policy=PositPolicy(weights=P16_2,
                                              kv_cache=P16_2)), n_layers=2)
        qparams = quantize_for_serving(init_params(cfg, seed=1,
                                                   device=self.dev), P16_2)
        B, P = 4, 32
        toks = np.random.default_rng(3).integers(
            0, cfg.vocab, (B, P + 1)).astype(np.int32)

        def run(params, dev):
            t = torch.from_numpy(toks).to(dev)
            pages = init_paged_pages(cfg, 1 + 3 * B, 16, device=dev)
            table = torch.arange(1, 1 + 3 * B, dtype=torch.int32,
                                 device=dev).reshape(B, 3)
            z = torch.zeros(B, dtype=torch.int32, device=dev)
            with torch.inference_mode():
                caches = assemble_paged_caches(pages, table, z, z + P)
                l1, _, caches = forward(params, cfg, tokens=t[:, :P],
                                        caches=caches)
                caches = assemble_paged_caches(extract_paged_pages(caches),
                                               table, z + P, z + 1)
                l2, _, _ = forward(params, cfg, tokens=t[:, P:],
                                   caches=caches)
            return torch.cat([l1, l2], dim=1).float().cpu()

        with self._recording_routes() as card_routes:
            gpu = run(qparams, self.dev)
        qparams = self._to(qparams, "cpu")
        t0 = time.perf_counter()
        with self._recording_routes() as cpu_routes:
            cpu = run(qparams, "cpu")
        cpu_s = time.perf_counter() - t0
        del qparams
        flips, masks = self._route_flips(card_routes, cpu_routes, P16_2)
        # calls: prefill layers 0, 1, then decode layers 0, 1
        touched = torch.zeros((B, P + 1), dtype=torch.bool)
        for i, m in enumerate(masks):
            layer, decode = i % cfg.n_layers, i >= cfg.n_layers
            for t in m.nonzero().flatten().tolist():
                b, s = (t, P) if decode else divmod(t, P)
                if layer < cfg.n_layers - 1:
                    touched[b, s:] = True
                else:
                    touched[b, s] = True
        keep = ~touched
        rel = float((gpu - cpu).abs()[keep].max() / cpu.abs()[keep].max())
        self.details["moe_logits"] = {
            "rel_err": rel, "flips": flips,
            "positions_compared": int(keep.sum()),
            "positions": keep.numel(), "cpu_s": cpu_s}
        log(f"[moe-check] depth-2 full-width olmoe logits, kernels on the "
            f"card vs plain on the CPU ({cpu_s:.1f} s, "
            f"{torch.get_num_threads()} threads): {len(flips)} route "
            f"flips {flips}; {int(keep.sum())} of {keep.numel()} positions "
            f"compared: max|diff|/max|logit| = {rel:.3e} (tol {LOGITS_TOL})")
        if any(not f["excused"] for f in flips):
            raise AssertionError("MoE logits: a route flip beyond the "
                                 "router's f32 bound")
        if not (np.isfinite(rel) and rel <= LOGITS_TOL):
            raise AssertionError("MoE logits: card and CPU disagree")

    def train_moe_whole_step(self):
        """One training step's loss and gradients of olmoe-1b-7b at full
        width, depth 2, posit16 STE weights, 2 x 128 tokens, without the
        per-layer recompute (the CPU side encodes and decodes each 64 x 2048
        x 1024 table through its plain version): the kernels on the card
        against the plain versions on the CPU, under the route-flip rule.  Expert slices whose kept token
        sets differ are left out of the gradient comparison, and the loss
        is held only when no flip happened."""
        torch = self.torch
        from repro_torch import configs, tree
        from repro_torch.core.types import P16_2
        from repro_torch.data.pipeline import DataConfig, global_batch_at
        from repro_torch.kernels import ops
        from repro_torch.models.transformer import init_params
        from repro_torch.quant.policy import PositPolicy
        from repro_torch.training.train_step import _compute_grads
        # remat off on both sides: the same function, and half the CPU's
        # posit16 round trips of the expert tables (~5 s each there)
        cfg = dataclasses.replace(configs.get_config(
            "olmoe-1b-7b", policy=PositPolicy(weights=P16_2)), n_layers=2,
            remat=False)
        gparams = init_params(cfg, seed=0, device=self.dev)
        batch = global_batch_at(0, DataConfig(vocab=cfg.vocab, seq_len=128,
                                              global_batch=2), device="cpu")
        ops.reset_counters()
        with self._recording_routes() as card_routes:
            loss_g, _, grads_g = _compute_grads(gparams, self._to(
                batch, self.dev), cfg, 1)
            torch.cuda.synchronize()
        if any(ops.plain_counts().values()):
            raise AssertionError(f"plain versions ran on the card: "
                                 f"{ops.plain_counts()}")
        grads_g = self._to(grads_g, "cpu")
        params = self._to(gparams, "cpu")
        del gparams
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with self._recording_routes() as cpu_routes:
            loss_c, _, grads_c = _compute_grads(params, batch, cfg, 1)
        cpu_s = time.perf_counter() - t0
        flips, _ = self._route_flips(card_routes, cpu_routes, P16_2)
        # expert slices whose kept token sets differ, per layer (the calls
        # alternate forward / recompute within each layer's order)
        skip = set()
        for i, (c, h) in enumerate(zip(card_routes, cpu_routes)):
            layer = i % cfg.n_layers
            for e in range(MOE_E):
                a = (c["idx"] == e) & c["keep"]
                b = (h["idx"] == e) & h["keep"]
                if not torch.equal(a.any(-1), b.any(-1)):
                    skip.add((layer, e))
        worst, compared = 0.0, 0
        for (path, a), b in zip(self._leaf_paths(grads_g),
                                tree.leaves(grads_c)):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"non-finite gradient {path}")
            diff = (a - b).abs()
            if path[0] == "layers" and path[2] == "moe" and \
                    path[3] != "router":
                sl = [e for e in range(MOE_E) if (path[1], e) not in skip]
                diff, b = diff[sl], b[sl]
            compared += diff.numel()
            worst = max(worst, float(diff.max() / b.abs().max()))
        rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
        self.details["moe_train_whole_step"] = {
            "loss_card": float(loss_g), "loss_cpu": float(loss_c),
            "loss_rel_err": rel, "grad_worst_err_over_max": worst,
            "flips": flips, "expert_slices_skipped": sorted(skip),
            "grad_entries_compared": compared, "cpu_s": cpu_s}
        log(f"[moe-train] depth-2 full-width p16 step, card (kernels) vs CPU "
            f"(plain, {cpu_s:.1f} s): loss {float(loss_g):.6f} vs "
            f"{float(loss_c):.6f}, rel err {rel:.3e} (tol {TRAIN_LOSS_RTOL}); "
            f"{len(flips)} route flips {flips}, {len(skip)} expert slices "
            f"left out; worst gradient leaf max|diff|/max|g| {worst:.3e} "
            f"(tol {TRAIN_GRAD_TOL})")
        if any(not f["excused"] for f in flips):
            raise AssertionError("MoE training step: a route flip beyond "
                                 "the router's f32 bound")
        if (not flips and rel > TRAIN_LOSS_RTOL) or worst > TRAIN_GRAD_TOL:
            raise AssertionError("MoE training step: card and CPU disagree")

    def _leaf_paths(self, tree_):
        """(path tuple, leaf) in repro_torch.tree.leaves order."""
        if isinstance(tree_, dict):
            return [((k,) + p, x) for k in sorted(tree_)
                    for p, x in self._leaf_paths(tree_[k])]
        if isinstance(tree_, (list, tuple)):
            return [((i,) + p, x) for i, v in enumerate(tree_)
                    for p, x in self._leaf_paths(v)]
        return [((), tree_)]

    def train_moe_deterministic(self):
        """The same MoE step (full width, depth 2, posit16 STE, 8 x 512
        tokens) twice from the same params and AdamW state: bit-identical
        params and state."""
        torch = self.torch
        from repro_torch import configs, tree
        from repro_torch.core.types import P16_2
        from repro_torch.data.pipeline import DataConfig, global_batch_at
        from repro_torch.models.transformer import init_params
        from repro_torch.optim.adamw import OptConfig, init_state
        from repro_torch.quant.policy import PositPolicy
        from repro_torch.training.train_step import make_train_step
        cfg = dataclasses.replace(configs.get_config(
            "olmoe-1b-7b", policy=PositPolicy(weights=P16_2)), n_layers=2)
        opt = OptConfig(lr_peak=3e-4, warmup_steps=1, total_steps=8)
        params = init_params(cfg, seed=0, device=self.dev)
        state = init_state(params, opt)
        batch = global_batch_at(0, DataConfig(vocab=cfg.vocab, seq_len=512,
                                              global_batch=8),
                                device=self.dev)
        step = make_train_step(cfg, opt, device=self.dev)
        first = step(params, state, batch)[:2]
        second = step(params, state, batch)[:2]
        same = [torch.equal(a, b) for a, b in zip(tree.leaves(first),
                                                   tree.leaves(second))]
        self.details["moe_deterministic_step"] = {
            "leaves": len(same), "bit_identical": all(same)}
        log(f"[moe-train] the same depth-2 step twice from one state: "
            f"{sum(same)} of {len(same)} leaves (params and AdamW state) "
            f"bit-identical")
        if not all(same):
            raise AssertionError("the MoE train step is not deterministic")

    # ---- phase 7: recurrent and hybrid serving -----------------------------
    def _scan_nn(self, T):
        """Ragged num_new over 8 slots, a 0 among them."""
        vals = [T, max(T - 1, 0), T // 2, 1, 0, T, min(3, T), T]
        return self.torch.tensor(vals, dtype=self.torch.int32,
                                 device=self.dev)

    def _scan_state(self, mode, shape, scale):
        """A seeded state of `mode` (p16, p8: posit bits; f32-rt: f32 of
        posit16 values; f32) -> (raw tensor, cfg_state, posit_state)."""
        from repro_torch.core.types import P8_2, P16_2
        from repro_torch.kernels import ref
        vals = self.randn(*shape, scale=scale)
        if mode in ("p16", "p8"):
            cfg = P16_2 if mode == "p16" else P8_2
            return ref.encode_ref(vals, cfg), cfg, True
        if mode == "f32-rt":
            return ref.rt(vals, P16_2), P16_2, False
        return vals, None, False

    def _same_bits(self, a, b):
        torch = self.torch
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return bool(torch.equal(a, b))

    def _wkv_y_bound(self, r, k, v, logw, u, s0f, nn, cfg):
        """Per-element bound on |K12's y - the plain y| when both carry the
        same state bits: each y is an f32 sum of dh + 1 rounded terms (the
        r.S dot product and the bonus (sum r u k) v) taken in another order,
        so each lies within gamma(dh + 4) of the exact sum of the terms'
        magnitudes, and the two within twice that."""
        torch = self.torch
        from repro_torch.kernels import ref
        dh = r.shape[-1]
        n = dh + 4
        g = 2 * n * 2.0 ** -24 / (1 - n * 2.0 ** -24)
        S = s0f
        out = []
        for t in range(r.shape[2]):
            rt_, kt, vt, wt = (x[:, :, t] for x in (r, k, v, logw))
            mag = (torch.einsum("bhd,bhdv->bhv", rt_.abs(), S.abs())
                   + (rt_ * u * kt).abs().sum(-1, keepdim=True) * vt.abs())
            out.append(g * mag)
            S_new = ref.rt(torch.exp(wt)[..., None] * S
                           + kt[..., None] * vt[:, :, None, :], cfg)
            S = torch.where((t < nn)[:, None, None, None], S_new, S)
        return torch.stack(out, dim=2)

    def _wkv_inputs(self, B, H, T, dh):
        r, k, v = (self.randn(B, H, T, dh) for _ in range(3))
        logw = -self.torch.exp(self.randn(B, H, T, dh, scale=0.5) - 1.0)
        u = self.randn(H, dh)
        return r, k, v, logw, u

    def check_round_trip(self):
        """The direct round trip (csrc/posit_codec.cuh::posit_rt: K12's,
        K13's and K1's round_trip_block's), through recurrent_scan.cu's
        check kernel, against posit_decode(posit_encode(x)) on every one
        of the 2^32 f32
        patterns: P16_2 and P8_2 in their compiled instances and at run
        time, and five formats only at run time (es 0, 1, 3 and 4); any
        mismatch fails."""
        from repro_torch.kernels import recurrent_scan as RS
        cases = [(16, 2, True), (8, 2, True), (16, 2, False), (8, 2, False),
                 (16, 1, False), (8, 0, False), (12, 3, False),
                 (16, 3, False), (16, 4, False)]
        rows = {}
        t0 = time.perf_counter()
        for n, es, spec in cases:
            bad, first = RS.round_trip_mismatches(n, es, spec)
            label = f"P{n}_{es} {'compiled' if spec else 'runtime'}"
            rows[label] = bad
            if bad:
                raise AssertionError(f"posit_rt {label}: {bad} of 2^32 f32 "
                                     f"patterns differ from the codec, the "
                                     f"first {first:#010x}")
        self.details["round_trip_mismatches"] = rows
        log(f"[round trip] posit_rt equals posit_decode(posit_encode()) on "
            f"all 2^32 f32 patterns for {', '.join(rows)} "
            f"({time.perf_counter() - t0:.1f} s)")

    def _misaligned(self, x):
        """x's values in a contiguous tensor that starts 4 bytes past an
        aligned address (the scans then take their 4-byte copies)."""
        buf = self.torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out

    def _check_wkv_case(self, label, r, k, v, logw, u, nn, mode):
        """K12 on one case against its plain version: the final state
        bit-identical, the idle slot (4) kept and its y 0, y within
        `_wkv_y_bound`, a repeated launch bit-identical."""
        torch = self.torch
        from repro_torch.kernels import recurrent_scan as RS
        from repro_torch.kernels import ref
        B, H, _, dh = r.shape
        s0, cfg, ps = self._scan_state(mode, (B, H, dh, dh), 0.5)
        y, sf = RS.wkv_scan(r, k, v, logw, u, s0, nn, cfg_state=cfg,
                            posit_state=ps)
        y_p, sf_p = RS.wkv_scan_plain(r, k, v, logw, u, s0, nn,
                                      cfg_state=cfg, posit_state=ps)
        y2, sf2 = RS.wkv_scan(r, k, v, logw, u, s0, nn, cfg_state=cfg,
                              posit_state=ps)
        torch.cuda.synchronize()
        for got, again in ((y, y2), (sf, sf2)):
            self._repeat_same(f"wkv_scan {label} {mode}", got, again)
        same = self._same_bits(sf, sf_p)
        idle = self._same_bits(sf[4], s0[4])
        s0f = ref.decode_ref(s0, cfg) if ps else s0
        tol = self._wkv_y_bound(r, k, v, logw, u, s0f, nn, cfg)
        log(f"[wkv_scan] {label} state {mode}: state bit-identical {same}, "
            f"idle slot kept {idle}")
        ratio = self._within("wkv_scan", f"{label} state {mode} y", y, y_p,
                             tol)
        if not (same and idle and bool((y[4] == 0).all())):
            raise AssertionError(f"wkv_scan {label} {mode}: state differs "
                                 f"from the plain version")
        self.details.setdefault("wkv_y_err_over_bound", {})[
            f"{label} {mode}"] = ratio

    def _check_rglru_case(self, label, a, b, nn, mode):
        """K13 on one case against its plain version: the h sequence and
        final state bit-identical, the idle slot (4) kept, a repeated
        launch bit-identical."""
        torch = self.torch
        from repro_torch.kernels import recurrent_scan as RS
        h0, cfg, ps = self._scan_state(mode, (a.shape[0], a.shape[2]), 1.0)
        h, hf = RS.rglru_scan(a, b, h0, nn, cfg_state=cfg, posit_state=ps)
        h_p, hf_p = RS.rglru_scan_plain(a, b, h0, nn, cfg_state=cfg,
                                        posit_state=ps)
        h2, hf2 = RS.rglru_scan(a, b, h0, nn, cfg_state=cfg, posit_state=ps)
        torch.cuda.synchronize()
        for got, again in ((h, h2), (hf, hf2)):
            self._repeat_same(f"rglru_scan {label} {mode}", got, again)
        ok = (self._same_bits(hf, hf_p) and self._same_bits(h, h_p)
              and self._same_bits(hf[4], h0[4]))
        self.err("rglru_scan", (h - h_p).abs().max())
        log(f"[rglru_scan] {label} state {mode}: h sequence and final state "
            f"bit-identical {ok}")
        if not ok:
            raise AssertionError(f"rglru_scan {label} {mode}: differs from "
                                 f"the plain version")

    def check_recurrent_kernels(self):
        """K12 and K13 against their plain versions at the serving shapes
        (rwkv6-3b: B = 8, H = 40, dh = 64; recurrentgemma-9b: B = 8, d =
        4,096), T = 1, 37, 128 and 130 (37 and 130 leave K12 a partial
        staging chunk), for posit16, posit8, f32 round-tripped
        through posit16 and plain f32 state, ragged num_new with a 0: the
        final state bit-identical, K13's h sequence bit-identical, K12's y
        within the f32 bound of `_wkv_y_bound`; the idle slot's bits come
        back as they went in; each launch repeated gives the same bits.
        Then the generic paths at T = 37: K12 at head_dim 18 (4-byte
        copies) and on inputs 4 bytes off alignment, K13 at an odd width
        and on misaligned inputs.  u, w_lora_b's product (logw) and the
        state are drawn from a seeded normal: the reference's init zeroes
        u and the decay LoRA."""
        torch = self.torch
        for T in (1, 37, 128, 130):
            nn = self._scan_nn(T)
            wkv = self._wkv_inputs(8, 40, T, 64)
            a = torch.sigmoid(self.randn(8, T, 4096) + 2.0)
            b = self.randn(8, T, 4096, scale=0.3)
            for mode in ("p16", "p8", "f32-rt", "f32"):
                self._check_wkv_case(f"T={T}", *wkv, nn, mode)
                self._check_rglru_case(f"T={T}", a, b, nn, mode)
        T = 37
        nn = self._scan_nn(T)
        for label, dh, off in (("dh=18", 18, False),
                               ("misaligned", 64, True)):
            r, k, v, logw, u = self._wkv_inputs(8, 4, T, dh)
            if off:
                r, k, v, logw = map(self._misaligned, (r, k, v, logw))
            for mode in ("p16", "f32"):
                self._check_wkv_case(f"T={T} {label}", r, k, v, logw, u, nn,
                                     mode)
        for label, d, off in (("d=4097", 4097, False),
                              ("misaligned", 4096, True)):
            a = torch.sigmoid(self.randn(8, T, d) + 2.0)
            b = self.randn(8, T, d, scale=0.3)
            if off:
                a, b = map(self._misaligned, (a, b))
            for mode in ("p16", "f32"):
                self._check_rglru_case(f"T={T} {label}", a, b, nn, mode)

    def _nar_pool(self, cfg, P, n_kv, page, D):
        """A pool whose garbage page 0 holds NaR (NaN for f32), and its twin
        with a finite garbage page."""
        torch = self.torch
        kp, vp = self._pool(cfg, P, n_kv, page, D)
        bad = (float("nan") if cfg is None else -(1 << (cfg.n - 1)))
        kn, vn = kp.clone(), vp.clone()
        kn[0] = bad
        vn[0] = bad
        kp[0] = 0
        vp[0] = 0
        return (kn, vn), (kp, vp)

    def _reclaimed_table(self, B, W, P, prev_len, window, page):
        """Distinct pages per sequence, with the pages a reclaiming engine
        has freed (entirely before `window` at length prev_len) pointing at
        the garbage page 0."""
        torch = self.torch
        table = self._table(B, W, P)
        n = ((prev_len - window).clamp(min=0) // page)
        j = torch.arange(W, device=self.dev)
        return torch.where(j[None, :] < n[:, None], 0, table).to(torch.int32)

    def check_attention_d256(self):
        """K3/K4 at recurrentgemma-9b's attention: D = 256, 16 query heads
        on one kv head, window 2,048, seq_lens up to 2,600, the pages before
        the window reclaimed to a garbage page of NaR patterns (NaN for f32
        pools): within ATTN_TOL of the plain version over the same pool
        with a finite garbage page, and bit-identical to the kernel's own
        result over that finite pool (the masked page never enters the
        arithmetic)."""
        torch = self.torch
        from repro_torch.core.types import P8_2, P16_2
        from repro_torch.kernels import flash_attention as F
        B, H, n_kv, page, D, win = 8, 16, 1, 16, 256, 2048
        W = -(-2600 // page)
        P = B * W + 1
        for cfg in (P16_2, P8_2, None):
            fmt = cfg or "float"
            (kn, vn), (kp, vp) = self._nar_pool(cfg, P, n_kv, page, D)
            sl = torch.tensor([1, 17, 300, 2047, 2048, 2049, 2600, 0],
                              dtype=torch.int32, device=self.dev)
            table = self._reclaimed_table(B, W, P, sl - 1, win, page)
            q = self.randn(B, H, D)
            live = (sl > 0)[:, None, None].expand(B, H, D)
            got = F.paged_flash_decode(q, kn, vn, table, sl, cfg_kv=cfg,
                                       window=win)
            clean = F.paged_flash_decode(q, kp, vp, table, sl, cfg_kv=cfg,
                                         window=win)
            want = F.paged_flash_decode_plain(q, kp, vp, table, sl,
                                              cfg_kv=cfg, window=win)
            if not self._same_bits(got, clean):
                raise AssertionError(f"paged_flash_decode D=256 {fmt}: the "
                                     f"NaR garbage page reached the output")
            self._repeat_same(f"paged_flash_decode D=256 {fmt}", got,
                              F.paged_flash_decode(q, kn, vn, table, sl,
                                                   cfg_kv=cfg, window=win))
            self._compare_attn("paged_flash_decode",
                               f"D=256 G=16 {fmt} window={win} NaR garbage",
                               got, want, live, dead_zero=True)
            Sq = 128
            qo = torch.tensor([0, 100, 1920, 2000, 2048, 2300, 2472, 5],
                              dtype=torch.int32, device=self.dev)
            nn = torch.tensor([128, 128, 128, 77, 128, 128, 128, 60],
                              dtype=torch.int32, device=self.dev)
            sl = qo + nn
            table = self._reclaimed_table(B, W, P, qo, win, page)
            q = self.randn(B, H, Sq, D)
            rows = torch.arange(Sq, device=self.dev)
            live = (rows[None, :] < nn[:, None])[:, None, :, None]
            live = live.expand(B, H, Sq, D)
            got = F.paged_flash_prefill(q, kn, vn, table, sl, qo, cfg_kv=cfg,
                                        window=win)
            clean = F.paged_flash_prefill(q, kp, vp, table, sl, qo,
                                          cfg_kv=cfg, window=win)
            want = F.paged_flash_prefill_plain(q, kp, vp, table, sl, qo,
                                               cfg_kv=cfg, window=win)
            if not self._same_bits(got[live], clean[live]):
                raise AssertionError(f"paged_flash_prefill D=256 {fmt}: the "
                                     f"NaR garbage page reached the output")
            self._repeat_same(f"paged_flash_prefill D=256 {fmt}", got,
                              F.paged_flash_prefill(q, kn, vn, table, sl, qo,
                                                    cfg_kv=cfg, window=win))
            self._compare_attn("paged_flash_prefill",
                               f"D=256 G=16 {fmt} Sq=128 window={win} NaR "
                               f"garbage", got, want, live, dead_zero=False)

    def check_flash_attention(self):
        """K14 ([BH, Sq, D] attention, queries at the last Sq positions)
        against its plain version: BH = 120 (8 x 15 heads), Sq = Skv = 512
        and Sq = 128 over Skv = 640, causal and not, posit16 and f32 KV, at
        D = 64, 256 and 80, within ATTN_TOL."""
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import flash_attention as F
        from repro_torch.kernels import ref
        BH = 120
        for D, (Sq, Skv) in itertools.product((64, 256, 80),
                                              ((512, 512), (128, 640))):
            q = self.randn(BH, Sq, D)
            k, v = self.randn(BH, Skv, D), self.randn(BH, Skv, D)
            for cfg in (P16_2, None):
                kb, vb = ((ref.encode_ref(k, cfg), ref.encode_ref(v, cfg))
                          if cfg else (k, v))
                for causal in (True, False):
                    got = F.flash_attention(q, kb, vb, cfg_kv=cfg,
                                            causal=causal)
                    want = F.flash_attention_plain(q, kb, vb, cfg_kv=cfg,
                                                   causal=causal)
                    live = self.torch.ones_like(got, dtype=self.torch.bool)
                    self._compare_attn(
                        "flash_attention", f"D={D} Sq={Sq} Skv={Skv} "
                        f"{cfg or 'float'} causal={causal}", got, want, live,
                        dead_zero=False)

    def attention_entry(self):
        """The K14 entry's own path: `ops.attention` on posit16 and f32 KV
        at [120, 512, 64], counters zeroed just before and read just
        after; no plain version may run."""
        from repro_torch.core.array import PositArray
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import ops, ref
        q = self.randn(120, 512, 64)
        k, v = self.randn(120, 512, 64), self.randn(120, 512, 64)
        kp = PositArray(ref.encode_ref(k, P16_2), P16_2)
        vp = PositArray(ref.encode_ref(v, P16_2), P16_2)
        self.torch.cuda.synchronize()
        ops.reset_counters()
        outs = [ops.attention(q, kp, vp), ops.attention(q, k, v)]
        self.torch.cuda.synchronize()
        launches, plain = ops.launch_counts(), ops.plain_counts()
        if any(plain.values()) or launches["flash_attention"] != 2 or \
                not all(bool(self.torch.isfinite(o).all()) for o in outs):
            raise AssertionError(f"ops.attention: launches {launches}, "
                                 f"plain {plain}")
        return {"flash_attention": launches["flash_attention"]}

    def time_scans(self, plain=True):
        """K12 and K13 at a decode step's (T = 1) and a prefill chunk's
        (T = 128) shapes with posit16 state, one layer each (rwkv6-3b: B =
        8, H = 40, dh = 64; recurrentgemma-9b: B = 8, d = 4,096), cold L2,
        beside the plain versions unless `plain` is False; records the
        decode shapes' rows.  Returns {label: numbers}."""
        torch = self.torch
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import recurrent_scan as RS
        from repro_torch.kernels import ref
        rows = {}
        for T in (1, 128):
            nn = torch.full((8,), T, dtype=torch.int32, device=self.dev)
            B, H, dh = 8, 40, 64
            n_in = 5 * B * H * T * dh * 4 + H * dh * 4
            n_state = 2 * B * H * dh * dh * 2
            nbytes = n_in + n_state
            sets = []
            for _ in range(copies_for(nbytes, 16)):
                r, k, v, logw, u = self._wkv_inputs(B, H, T, dh)
                s0 = ref.encode_ref(self.randn(B, H, dh, dh, scale=0.5),
                                    P16_2)
                sets.append((r, k, v, logw, u, s0, nn))
            flops = 5.0 * B * H * T * dh * dh
            bnd, by = bound(nbytes, flops)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            issue = (K12_INSTR_PER_ELEMENT * B * H * T * dh * dh / 32
                     / (sms * 4 * gpu_max_sm_clock_mhz() * 1e6) * 1e3)
            kw = dict(cfg_state=P16_2, posit_state=True)
            kern = time_ms(torch, lambda *a: RS.wkv_scan(*a, **kw), sets,
                           ITERS, "wkv_scan")
            plain_ms = (time_ms(torch, lambda *a: RS.wkv_scan_plain(
                *a, **kw), sets, 3 if T > 1 else 10, "wkv_scan_plain")
                if plain else None)
            rows[f"wkv_scan T={T}"] = dict(ms=kern, plain_ms=plain_ms,
                                           bound_ms=bnd, bound_by=by,
                                           issue_ms_estimate=issue)
            if T == 1:
                self.record("wkv_scan", shape="one rwkv6-3b layer, decode "
                            "step: B=8, H=40, dh=64, p16 state",
                            ms=kern, plain_ms=plain_ms, library_ms=None,
                            bound_ms=bnd, bound_by=by)
            d = 4096
            nbytes = 3 * B * T * d * 4 + 2 * B * d * 2
            sets = []
            for _ in range(copies_for(nbytes, 16)):
                a = torch.sigmoid(self.randn(B, T, d) + 2.0)
                b = self.randn(B, T, d, scale=0.3)
                h0 = ref.encode_ref(self.randn(B, d), P16_2)
                sets.append((a, b, h0, nn))
            bnd, by = bound(nbytes, 2.0 * B * T * d)
            kern = time_ms(torch, lambda *a: RS.rglru_scan(*a, **kw), sets,
                           ITERS, "rglru_scan")
            plain_ms = (time_ms(torch, lambda *a: RS.rglru_scan_plain(
                *a, **kw), sets, 3 if T > 1 else 10, "rglru_scan_plain")
                if plain else None)
            rows[f"rglru_scan T={T}"] = dict(ms=kern, plain_ms=plain_ms,
                                             bound_ms=bnd, bound_by=by)
            if T == 1:
                self.record("rglru_scan", shape="one recurrentgemma-9b "
                            "layer, decode step: B=8, d=4096, p16 state",
                            ms=kern, plain_ms=plain_ms, library_ms=None,
                            bound_ms=bnd, bound_by=by)

        card = self.details["gpu"]
        for name, rec in rows.items():
            pl, issue = rec["plain_ms"], rec.get("issue_ms_estimate")
            log(f"[time] {name}: {rec['ms']:.4f} ms ("
                f"{'' if pl is None else f'plain {pl:.4f}, '}bound "
                f"{rec['bound_ms']:.4f} by {rec['bound_by']}"
                f"{'' if issue is None else f'; issue-rate estimate {issue:.4f}'}"
                f") ({card})")
        self.details.setdefault("scan_times", {}).update(rows)
        return rows

    def time_recurrent_kernels(self):
        """K12 and K13 at a decode step's (T = 1) and a prefill chunk's
        (T = 128) shapes with posit16 state, one layer each; K3/K4 at D =
        256, G = 16 (recurrentgemma's attention) at the smollm rows' lengths
        and at 8 x 2,208 tokens with the 2,048 window (time_paged, beside
        SDPA with the window's mask); K14 at [120, 512, 64] and [128, 512,
        256] causal, posit16 and f32 KV, beside SDPA."""
        torch = self.torch
        from repro_torch.core.types import P16_2
        from repro_torch.kernels import flash_attention as F
        from repro_torch.kernels import ref
        rows = self.time_scans()

        # K3/K4 at D = 256, G = 16 (beside SDPA with the window's mask)
        rows.update(self.time_paged(("d256",)))

        # K14 at [120, 512, 64] and [128, 512, 256], posit16 KV, causal
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for BH, Sq, D in ((120, 512, 64), (128, 512, 256)):
            nbytes = 2 * BH * Sq * D * 4 + 2 * BH * Sq * D * 2
            sets, lib_sets = [], []
            for _ in range(copies_for(nbytes, 16)):
                q = self.randn(BH, Sq, D)
                k, v = self.randn(BH, Sq, D), self.randn(BH, Sq, D)
                sets.append((q, ref.encode_ref(k, P16_2),
                             ref.encode_ref(v, P16_2)))
                lib_sets.append((q[None], k[None], v[None]))
            bnd, by = bound(nbytes, 4.0 * BH * Sq * (Sq + 1) / 2 * D)
            kern = time_ms(torch, lambda *a: F.flash_attention(
                *a, cfg_kv=P16_2), sets, ITERS, f"flash_attention D={D}")
            plain = time_ms(torch, lambda *a: F.flash_attention_plain(
                *a, cfg_kv=P16_2), sets, 5, f"flash_attention_plain D={D}")
            lib = time_ms(torch, lambda q, k, v: sdpa(q, k, v,
                                                      is_causal=True),
                          lib_sets, ITERS, f"sdpa D={D}")
            rows[f"flash_attention [{BH}, {Sq}, {D}]"] = dict(
                ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                bound_by=by)
            # the same on f32 KV: what the posit decode costs
            kf32 = time_ms(torch, lambda q, k, v: F.flash_attention(
                q[0], k[0], v[0]), lib_sets, ITERS,
                f"flash_attention f32 KV D={D}")
            rows[f"flash_attention [{BH}, {Sq}, {D}] f32 KV"] = dict(
                ms=kf32, plain_ms=None, library_ms=lib,
                bound_ms=bound(4 * BH * Sq * D * 4, 4.0 * BH * Sq * (Sq + 1)
                               / 2 * D)[0], bound_by=by)
            if D == 64:
                self.record("flash_attention", shape="[120, 512, 64] (8 x 15 "
                            "heads), causal, p16 KV", ms=kern,
                            plain_ms=plain, library_ms=lib, bound_ms=bnd,
                            bound_by=by)
            del sets, lib_sets
        self.details["recurrent_kernel_times"] = rows
        card = self.details["gpu"]
        for name, rec in rows.items():
            if name.startswith(("paged_", "wkv_scan", "rglru_scan")):
                continue                        # logged by their timers
            lib, pl = rec.get("library_ms"), rec["plain_ms"]
            log(f"[time] {name}: {rec['ms']:.4f} ms ("
                f"{'' if pl is None else f'plain {pl:.4f}, '}"
                f"{'' if lib is None else f'SDPA {lib:.4f}, '}bound "
                f"{rec['bound_ms']:.4f} by {rec['bound_by']}) ({card})")

    def check_recurrent_logits(self, arch, n_layers, gate=True):
        """Card vs CPU at full width and depth `n_layers`: the posit16 PTQ
        weights made on the card, a 4 x 32-token paged prefill and one
        decode step, the kernels on the card and the plain versions on the
        CPU; logits within LOGITS_TOL of the largest, and the state
        patterns that differ reported (a last-bit difference of the GEMMs'
        sums that straddles a posit rounding flips a pattern, which the
        state carries on).  The CPU side takes the weights decoded on the
        card (the codec is bit-exact, phase 2) as f32 tables, with the KV
        and state policy kept: its plain GEMMs multiply the same values
        the plain posit GEMM would decode, without decoding 1.7 B weights
        (recurrentgemma's 256,000 x 4,096 table among them) in every
        call.  With gate False (rwkv6-3b) the comparison is reported only:
        there a pattern flipped in one layer's posit16 state carries into
        the next layer's inputs, and `check_rwkv_layers` holds each layer
        from the card's own inputs instead."""
        torch = self.torch
        import numpy as np
        from repro_torch import configs
        from repro_torch.core.types import P16_2
        from repro_torch.models.transformer import (assemble_paged_caches,
                                                    extract_paged_pages,
                                                    forward, init_params,
                                                    init_paged_pages)
        from repro_torch.quant.policy import PositPolicy
        from repro_torch.quant.ptq import quantize_for_serving
        cfg = dataclasses.replace(configs.get_config(
            arch, policy=PositPolicy(weights=P16_2, kv_cache=P16_2)),
            n_layers=n_layers)
        params = init_params(cfg, seed=0, device=self.dev)
        qparams = quantize_for_serving(params, P16_2)
        del params
        rng = np.random.default_rng(5)
        B, S, page, W = 4, 32, 16, 3
        toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)

        def run(params, cfg, dev):
            t = torch.from_numpy(toks).to(dev)
            pages = init_paged_pages(cfg, 1 + B * W, page, max_seqs=B,
                                     device=dev)
            table = (1 + torch.arange(B * W, dtype=torch.int32,
                                      device=dev)).reshape(B, W)
            z = torch.zeros(B, dtype=torch.int32, device=dev)
            with torch.inference_mode():
                c = assemble_paged_caches(pages, table, z, z + S)
                l1, _, c = forward(params, cfg, tokens=t[:, :S], caches=c)
                c = assemble_paged_caches(extract_paged_pages(c), table,
                                          z + S, z + 1)
                l2, _, c = forward(params, cfg, tokens=t[:, S:], caches=c)
            states = [{k: getattr(v, "bits", v).cpu() for k, v in
                       layer.items()} for layer in
                      extract_paged_pages(c)["layers"]
                      if "k_pages" not in layer]
            return torch.cat([l1, l2], dim=1).float().cpu(), states

        gpu, g_states = run(qparams, cfg, self.dev)

        def decoded(tree):
            if isinstance(tree, dict):
                return {k: decoded(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [decoded(v) for v in tree]
            return getattr(tree, "to_f32", lambda: tree)().cpu()

        cpu_params = decoded(qparams)
        del qparams
        torch.cuda.empty_cache()
        cpu_cfg = dataclasses.replace(cfg, policy=PositPolicy(
            kv_cache=P16_2))
        t0 = time.perf_counter()
        cpu, c_states = run(cpu_params, cpu_cfg, "cpu")
        cpu_s = time.perf_counter() - t0
        rel = float((gpu - cpu).abs().max() / cpu.abs().max())
        n_diff = n_all = far = 0
        for gs, cs in zip(g_states, c_states):
            for key in gs:
                d = (gs[key].long() - cs[key].long()).abs()
                n_diff += int((d > 0).sum())
                n_all += d.numel()
                far = max(far, int(d.max()))
        same = bool((gpu.argmax(-1) == cpu.argmax(-1)).all())
        self.details[f"{arch}_logits"] = {
            "n_layers": n_layers, "rel_err": rel, "cpu_s": cpu_s,
            "state_patterns_differing": n_diff, "state_patterns": n_all,
            "state_max_pattern_distance": far, "argmax_equal": same}
        log(f"[check] {arch} full width, depth {n_layers}: logits card vs "
            f"CPU max|diff|/max|logit| = {rel:.3e} (tol {LOGITS_TOL}); "
            f"argmax equal: {same}; state patterns differing {n_diff} of "
            f"{n_all} (max {far} apart); CPU side {cpu_s:.1f} s")
        if gate and not (np.isfinite(rel) and rel <= LOGITS_TOL):
            raise AssertionError(f"{arch} logits disagree")

    def check_rwkv_layers(self, arch="rwkv6-3b", n_layers=2):
        """rwkv6-3b card vs CPU one layer at a time, at full width and depth
        `n_layers`, on `check_recurrent_logits`' inputs (posit16 PTQ weights
        made on the card, a 4 x 32-token paged prefill and one decode step).
        The card runs the model with each layer's inputs recorded: its
        hidden state, and the state pools it starts from (posit16 WKV
        state and token shifts).  The CPU then runs every layer of both
        steps from those same inputs, and the head from the card's last
        hidden state, with the plain versions on the card-decoded weights.
        Each layer's output must lie within LOGITS_TOL of the card's
        (relative to its largest entry), and each step's logits within
        LOGITS_TOL of the largest card logit.  Starting every layer from the
        card's own inputs leaves only that layer's arithmetic between the
        two: f32 sums in two orders (relative ~1e-6) and the posit16 state
        patterns those differences flip inside the layer, each one posit16
        step of one state entry; a flip no longer carries into the next
        layer, as it does in the whole-model comparison.  The state
        patterns that differ are reported per layer."""
        torch = self.torch
        import numpy as np
        from repro_torch import configs
        from repro_torch.core.array import PositArray
        from repro_torch.core.types import P16_2
        from repro_torch.models import blocks as MB
        from repro_torch.models import transformer as T
        from repro_torch.quant.policy import PositPolicy
        from repro_torch.quant.ptq import quantize_for_serving
        cfg = dataclasses.replace(configs.get_config(
            arch, policy=PositPolicy(weights=P16_2, kv_cache=P16_2)),
            n_layers=n_layers)
        params = T.init_params(cfg, seed=0, device=self.dev)
        qparams = quantize_for_serving(params, P16_2)
        del params
        rng = np.random.default_rng(5)
        B, S, page, W = 4, 32, 16, 3
        toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)

        def cpu(tree):
            if isinstance(tree, dict):
                return {k: cpu(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [cpu(v) for v in tree]
            if isinstance(tree, PositArray):
                return PositArray(tree.bits.cpu(), tree.cfg)
            return tree.detach().cpu() if torch.is_tensor(tree) else tree

        records = []
        layer = T._layer

        def recording(x, p, cfg_, kind, positions, cache):
            inputs = (cpu(x), cpu(positions), cpu(cache))
            out = layer(x, p, cfg_, kind, positions, cache)
            records.append((kind, inputs, cpu(out[0]), cpu(out[1])))
            return out

        t = torch.from_numpy(toks).to(self.dev)
        pages = T.init_paged_pages(cfg, 1 + B * W, page, max_seqs=B,
                                   device=self.dev)
        table = (1 + torch.arange(B * W, dtype=torch.int32,
                                  device=self.dev)).reshape(B, W)
        z = torch.zeros(B, dtype=torch.int32, device=self.dev)
        T._layer = recording
        try:
            with torch.inference_mode():
                c = T.assemble_paged_caches(pages, table, z, z + S)
                l1, _, c = T.forward(qparams, cfg, tokens=t[:, :S], caches=c)
                c = T.assemble_paged_caches(T.extract_paged_pages(c), table,
                                            z + S, z + 1)
                l2, _, c = T.forward(qparams, cfg, tokens=t[:, S:], caches=c)
        finally:
            T._layer = layer
        card_logits = [l1.float().cpu(), l2.float().cpu()]

        def decoded(tree):
            if isinstance(tree, dict):
                return {k: decoded(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [decoded(v) for v in tree]
            return getattr(tree, "to_f32", lambda: tree)().cpu()

        cpu_params = decoded(qparams)
        del qparams, c, pages
        torch.cuda.empty_cache()
        cpu_cfg = dataclasses.replace(cfg, policy=PositPolicy(
            kv_cache=P16_2))
        t0 = time.perf_counter()
        rows, worst = [], 0.0
        with torch.inference_mode():
            for i, (kind, (x, pos, cache), y_card, nc_card) in \
                    enumerate(records):
                step, li = divmod(i, n_layers)
                y, nc, _ = T._layer(x, cpu_params["layers"][li], cpu_cfg,
                                    kind, pos, cache)
                diff = float((y - y_card).abs().max())
                rel = diff / float(y_card.abs().max())
                upd = diff / float((y_card - x).abs().max())
                n_diff = n_all = 0
                for key in ("wkv", "tshift", "cshift"):
                    a = getattr(nc[key], "bits", nc[key])
                    b = getattr(nc_card[key], "bits", nc_card[key])
                    n_diff += int((a != b).sum())
                    n_all += a.numel()
                worst = max(worst, rel)
                rows.append({"step": ("prefill", "decode")[step],
                             "layer": li, "rel_err": rel,
                             "rel_err_of_update": upd,
                             "state_patterns_differing": n_diff,
                             "state_patterns": n_all})
                log(f"[check] {arch} layer {li} {rows[-1]['step']} from the "
                    f"card's inputs: max|diff|/max|out| = {rel:.3e} (tol "
                    f"{LOGITS_TOL}; {upd:.3e} of the layer's update); state "
                    f"patterns differing {n_diff} of {n_all}")
            for step in range(2):
                h = records[step * n_layers + n_layers - 1][2]
                logits = MB.unembed(MB.rms_norm(h, cpu_params["ln_f"]),
                                    cpu_params["embed"], cpu_cfg.policy)
                want = card_logits[step]
                rel = float((logits - want).abs().max() / want.abs().max())
                worst = max(worst, rel)
                rows.append({"step": ("prefill", "decode")[step],
                             "layer": "head", "rel_err": rel})
                log(f"[check] {arch} head {rows[-1]['step']} from the card's "
                    f"last hidden state: max|diff|/max|logit| = {rel:.3e} "
                    f"(tol {LOGITS_TOL})")
        cpu_s = time.perf_counter() - t0
        self.details[f"{arch}_layers"] = {"n_layers": n_layers,
                                          "worst_rel_err": worst,
                                          "rows": rows, "cpu_s": cpu_s}
        log(f"[check] {arch} per layer, depth {n_layers}: worst "
            f"{worst:.3e} of LOGITS_TOL {LOGITS_TOL} "
            f"({worst / LOGITS_TOL:.1%}); CPU side {cpu_s:.1f} s")
        if not (np.isfinite(worst) and worst <= LOGITS_TOL):
            raise AssertionError(f"{arch} layers disagree")

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
# olmoe-1b-7b's MoE: experts, top-k, and the (name, K, N) of its expert
# tables (w_up and w_gate share a shape)
MOE_E, MOE_K = 64, 8
MOE_TRAIN_LAYERS = 4
MOE_SHAPES = [("up/gate", 2048, 1024), ("down", 1024, 2048)]
# recurrentgemma-9b's drain adds requests past its 2,048-token window
LONG_PROMPT = 2176
# (arch, H, n_kv, head_dim, causal in the training case) of the head
# layouts the flash kernels (K7-K9) are checked at: smollm-360m's 3 query
# heads per kv head, olmoe-1b-7b's 1 at D = 128, recurrentgemma-9b's 16 on
# one kv head at D = 256, hubert-xlarge's bidirectional D = 80
FLASH_LAYOUTS = [("smollm-360m", 15, 5, 64, True),
                 ("olmoe-1b-7b", 16, 16, 128, True),
                 ("recurrentgemma-9b", 16, 1, 256, True),
                 ("hubert-xlarge", 16, 16, 80, False)]
# K10's decode and tiled forms and K11
GROUPED_KERNEL_SYMBOLS = ("grouped_stream_kernel", "grouped_mma_kernel",
                          "grouped_dw_kernel")
# the flash kernels' device symbols (K7 and K14, K4: K7's paged instance,
# K8, K9)
FLASH_KERNEL_SYMBOLS = ("flash_fwd_kernel", "flash_fwd_paged_kernel",
                        "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
TRAINING_KERNELS = ("flash_prefill", "flash_prefill_bwd_dq",
                    "flash_prefill_bwd_dkv", "posit_gemm_transpose_a",
                    "round_trip_block")
# K1's device symbols: decode, encode, the round trip, the append
CODEC_KERNEL_SYMBOLS = ("decode_block_kernel", "encode_block_kernel",
                        "round_trip_kernel", "paged_append_kernel")
SERVING_KERNELS = ("decode_block", "encode_block", "paged_append", "pw_gemm",
                   "paged_flash_decode", "paged_flash_prefill")

PREFILL_ROWS = 8 * 128      # a prefill step's rows: max_seqs x chunk
DECODE_ROWS = 8
# the served models whose decode shapes the skinny K2 is checked at (and,
# from the third on, timed at beside smollm-360m's GEMM_SHAPES)
SKINNY_ARCHS = ("smollm-360m", "olmoe-1b-7b", "rwkv6-3b",
                "recurrentgemma-9b")


def served_decode_shapes(arch: str) -> dict[tuple[int, int, bool], int]:
    """{(K, N, transpose_b): GEMMs a decode step} of the pw_gemm calls of
    `arch`'s full config: its "w" linears [K, N] and tied "table" [V, d],
    walked as `gemm_weights` walks the params of an init whose random
    tables are meta tensors (no memory)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import blocks, griffin, moe, rwkv6, transformer

    def meta(gen, shape, scale):
        return torch.empty(shape, device="meta")

    mods = (blocks, griffin, moe, rwkv6)
    saved = [m._normal for m in mods]
    for m in mods:
        m._normal = meta
    try:
        params = transformer.init_params(configs.get_config(arch), seed=0,
                                         device="cpu")
    finally:
        for m, f in zip(mods, saved):
            m._normal = f
    out: dict[tuple[int, int, bool], int] = {}
    for name, (r, c) in gemm_weights(params):
        if name == "router":
            continue
        key = (c, r, True) if name == "table" else (r, c, False)
        out[key] = out.get(key, 0) + 1
    return out


def sass_loop_profile(lib_path: str, kernel: str, mp: int) -> dict:
    """The main loop of one skinny-kernel instance in `cuobjdump -sass`:
    the smallest span between a backward branch and its target that holds
    the cp.async ring's copies (LDGSTS) and FFMAs (each weight element
    takes mp of them).  Returns its static instructions per weight
    element, all of them and those of the fast path: the blocks a branch
    skips that hold posit_decode (the only FLO) and no FFMA, the flagged
    loads' fallback, are left out.  A diagnostic of the code, not a
    timing."""
    import re
    for chunk in cuobjdump_sass(lib_path).split("Function : ")[1:]:
        if kernel not in chunk.split("\n", 1)[0]:
            continue
        ins = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", t))
               for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;",
                                      chunk)]
        ops = [t.split()[0].split(".")[0] for _, t in ins]
        target = [re.search(r"\bBRA\S*\s+(?:`\()?(0x[0-9a-f]+)", t)
                  for _, t in ins]
        best = None
        for i, m in enumerate(target):
            if not m or int(m.group(1), 16) >= ins[i][0]:
                continue
            lo, hi = int(m.group(1), 16), ins[i][0]
            idx = [j for j, (a, _) in enumerate(ins) if lo <= a <= hi]
            span = [ops[j] for j in idx]
            if "LDGSTS" not in span or "FFMA" not in span:
                continue
            key = -len(span)
            if best is None or key > best[0]:
                best = (key, idx)
        if best is None:
            raise RuntimeError(f"{kernel}: no loop in its SASS")
        idx = best[1]
        cold = set()
        for j in idx:
            m = target[j]
            if m and int(m.group(1), 16) > ins[j][0]:
                skip = [k for k in idx
                        if ins[j][0] < ins[k][0] < int(m.group(1), 16)]
                kinds_in = {ops[k] for k in skip}
                if "FLO" in kinds_in and "FFMA" not in kinds_in:
                    cold.update(skip)
        elements = sum(ops[j] == "FFMA" for j in idx) // mp
        hot = [ops[j] for j in idx if j not in cold]
        kinds = {"ffma": ("FFMA",), "shared": ("LDS", "STS", "LDGSTS"),
                 "global": ("LDG", "STG"),
                 "branch": ("BRA", "BSSY", "BSYNC", "EXIT", "WARPSYNC")}
        counts = {k: sum(hot.count(o) for o in v) for k, v in kinds.items()}
        counts["integer"] = len(hot) - sum(counts.values())
        n = max(elements, 1)
        return {"instructions": len(idx), "elements": elements,
                "per_element": len(idx) / n, "fast_path": len(hot),
                "fast_per_element": len(hot) / n,
                "fast_integer_per_element": counts["integer"] / n,
                "fast_counts": counts}
    raise RuntimeError(f"{kernel} not in the SASS of {lib_path}")


def gemm_weights(params) -> list[tuple[str, tuple[int, int]]]:
    """(name, shape) of every 2-D weight a model multiplies through K2:
    the "w" linears [K, N], the tied "table" [V, d] (transpose_b) and the
    MoE "router" [d, E] (f32, through posit_gemm, in serving too)."""
    out = []

    def walk(t, name=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, k)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v, name)
        else:
            shape = tuple(getattr(t, "bits", t).shape)
            if name in ("w", "table", "router") and len(shape) == 2:
                out.append((name, shape))

    walk(params)
    return out


def splitk_reduces(shapes) -> int:
    """How many of the tiled K2 launches of `shapes` ((M, N, K, kinds,
    transpose_a, transpose_b) each) the plan splits over K, each followed
    by one launch of the split-K reduce."""
    from repro_torch.kernels.posit_gemm import gemm_plan
    return sum(gemm_plan(*sh).splits > 1 for sh in shapes)


def serving_launches(cfg, prefill_steps: int, decode_steps: int,
                     weights=()):
    """The launches one drain of `cfg` must make, and those of them that
    the PTQ makes (not per step).  Per attention layer and step: the paged
    append and attention, and the GEMMs (dense: 7 `pw_gemm`; MoE: 4
    `pw_gemm`, the f32 router's `posit_gemm` after its posit round trip,
    one `round_trip_block`, and 3 `grouped_gemm`).  Per rwkv6 layer and
    step: 8 `pw_gemm` (5 time-mix, 3 channel-mix projections), the WKV
    scan, and for each of its two token shifts a decode from the pool, a
    `round_trip_block` at use and an encode back.  Per rglru layer and
    step: 8 `pw_gemm` (5 block projections, 3 MLP), the RG-LRU scan, and
    the conv tail's decode, `round_trip_block` and encode.  Per step the
    unembedding and the embedding rows' decode; the PTQ encodes every
    weight table.  A prefill step's `pw_gemm`s (M = 1,024 rows) and
    the MoE router's `posit_gemm` (M = 8 or 1,024) run the tiled kernel:
    each one its plan splits over K adds one split-K reduce
    (`pw_gemm_reduce`, `posit_gemm_reduce`); `weights` (`gemm_weights` of
    the served params) gives their shapes."""
    L = cfg.n_layers
    steps = prefill_steps + decode_steps
    kinds = [cfg.kind(i) for i in range(L)]
    n_attn = sum(k in ("attn", "attn_local") for k in kinds)
    n_rwkv, n_rg = kinds.count("rwkv6"), kinds.count("rglru")
    tables = 7 * n_attn + 8 * (n_rwkv + n_rg) + 1
    # state leaves a step: each one decode, one round trip, one encode
    codec = 2 * n_rwkv + n_rg
    expect = {"paged_flash_decode": n_attn * decode_steps,
              "paged_flash_prefill": n_attn * prefill_steps,
              "paged_append": n_attn * steps,
              "wkv_scan": n_rwkv * steps, "rglru_scan": n_rg * steps}
    pw = [(PREFILL_ROWS, r, c, ("f32", "posit"), False, True)
          if name == "table" else
          (PREFILL_ROWS, c, r, ("f32", "posit"), False, False)
          for name, (r, c) in weights if name != "router"]
    routers = [(M, c, r, ("f32", "f32"), False, False)
               for name, (r, c) in weights if name == "router"
               for M in (DECODE_ROWS, PREFILL_ROWS)]
    expect["pw_gemm_reduce"] = splitk_reduces(pw) * prefill_steps
    if cfg.moe is None:
        expect.update(pw_gemm=tables * steps,
                      decode_block=(1 + codec) * steps,
                      encode_block=tables + codec * steps,
                      round_trip_block=codec * steps)
    else:
        if n_rwkv or n_rg:
            raise NotImplementedError("MoE launch structure is for "
                                      "attention stacks")
        expect.update(posit_gemm_reduce=(
            splitk_reduces(routers[0::2]) * decode_steps
            + splitk_reduces(routers[1::2]) * prefill_steps))
        expect.update(pw_gemm=(4 * L + 1) * steps, posit_gemm=L * steps,
                      grouped_gemm=3 * L * steps,
                      decode_block=steps, encode_block=tables,
                      round_trip_block=L * steps)
    return expect, {"encode_block": tables}


def training_launches(cfg, steps: int, p16: bool, weights=(),
                      tokens: int = 8 * 512):
    """The launches `steps` training steps of `cfg` must make.  Per layer
    the posit GEMM runs the attention projections (and, for MoE, the
    router): 7 per dense layer, 5 per MoE layer, + the tied LM head; each
    forward, recomputed, and twice in the backward (dA, and dB by
    `transpose_a`).  An MoE layer's three expert GEMMs run K10 forward,
    recomputed and as dX (`transpose_b`), and K11 once.  With posit16 STE
    weights every float table is cast (one `round_trip_block`) in the
    forward and the recompute (7 per dense layer, 8 per MoE layer: the
    router and three expert tables in place of the MLP's three), and the
    tied table 3 times (embed, unembed, its recompute).  Each GEMM the
    plan splits over K adds one split-K reduce (`posit_gemm_reduce`):
    `weights` (`gemm_weights` of the trained params) gives the shapes at
    M = `tokens` rows: the forward twice, dX and dW."""
    L = cfg.n_layers
    f = ("f32", "f32")
    per_step = 0
    for name, (r, c) in weights:
        if name == "table":                      # [V, d], transpose_b
            fwd, dx, dw = ((tokens, r, c, f, False, True),
                           (tokens, c, r, f, False, False),
                           (r, c, tokens, f, True, False))
        else:                                    # [K, N]
            fwd, dx, dw = ((tokens, c, r, f, False, False),
                           (tokens, r, c, f, False, True),
                           (r, c, tokens, f, True, False))
        per_step += splitk_reduces([fwd, fwd, dx, dw])
    g = (5 if cfg.moe else 7) * L + 1
    casts = (2 * (8 if cfg.moe else 7) * L + 3) if p16 else 0
    expect = {"posit_gemm": 4 * g * steps,
              "posit_gemm_transpose_a": g * steps,
              "posit_gemm_reduce": per_step * steps,
              "flash_prefill": 2 * L * steps,
              "flash_prefill_bwd_dq": L * steps,
              "flash_prefill_bwd_dkv": L * steps,
              "round_trip_block": casts * steps, "encode_block": 0,
              "decode_block": 0}
    if cfg.moe:
        expect.update(grouped_gemm=9 * L * steps,
                      grouped_gemm_transpose_b=3 * L * steps,
                      grouped_gemm_dw=3 * L * steps)
    return expect


KERNEL_META = {
    "decode_block": ("src/repro_torch/csrc/posit_codec.cu",
                     "src/repro/kernels/posit_codec.py:41"),
    "encode_block": ("src/repro_torch/csrc/posit_codec.cu",
                     "src/repro/kernels/posit_codec.py:59"),
    "round_trip_block": ("src/repro_torch/csrc/posit_codec.cu",
                         "src/repro/kernels/posit_codec.py:59"),
    "paged_append": ("src/repro_torch/csrc/posit_codec.cu",
                     "src/repro/kernels/posit_codec.py:59"),
    "pw_gemm": ("src/repro_torch/csrc/posit_gemm.cu",
                "src/repro/kernels/posit_gemm.py:158"),
    "paged_flash_decode": ("src/repro_torch/csrc/paged_attention.cu",
                           "src/repro/kernels/flash_attention.py:650"),
    "paged_flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
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
    "grouped_gemm": ("src/repro_torch/csrc/grouped_gemm.cu",
                     "src/repro/kernels/grouped_gemm.py:146"),
    "grouped_gemm_dw": ("src/repro_torch/csrc/grouped_gemm.cu",
                        "src/repro/kernels/grouped_gemm.py:272"),
    "wkv_scan": ("src/repro_torch/csrc/recurrent_scan.cu",
                 "src/repro/kernels/recurrent_scan.py:107"),
    "rglru_scan": ("src/repro_torch/csrc/recurrent_scan.cu",
                   "src/repro/kernels/recurrent_scan.py:203"),
    "flash_attention": ("src/repro_torch/csrc/flash_prefill.cu",
                        "src/repro/kernels/flash_attention.py:710"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write every number "
                    "to this JSON file")
    ap.add_argument("--rwkv-layers", action="store_true", help="run only "
                    "the per-layer rwkv6-3b card-vs-CPU check and print its "
                    "numbers")
    ap.add_argument("--skinny-times", action="store_true", help="run only "
                    "the skinny form's timings (with --src, another "
                    "commit's kernel under the same harness)")
    ap.add_argument("--grouped-times", action="store_true", help="run only "
                    "K10/K11's timings at olmoe-1b-7b's decode, prefill and "
                    "training shapes, without the plain versions (with "
                    "--src, another commit's kernels under the same "
                    "harness)")
    ap.add_argument("--paged-times", action="store_true", help="run only "
                    "K3/K4's timings at smollm-360m's and recurrentgemma-"
                    "9b's layers, beside SDPA, without the plain versions "
                    "(with --src, another commit's kernels through its own "
                    "wrappers under the same harness)")
    ap.add_argument("--scan-times", action="store_true", help="run only "
                    "K12/K13's timings at rwkv6-3b's and recurrentgemma-"
                    "9b's decode and prefill shapes, without the plain "
                    "versions (with --src, another commit's kernels "
                    "through its own wrappers under the same harness)")
    ap.add_argument("--codec-times", action="store_true", help="run only "
                    "K1's timings (decode, encode, the append, and the "
                    "round trip at an olmoe-1b-7b expert stack beside "
                    "decode(encode())), without the plain versions (with "
                    "--src, another commit's kernels through its own "
                    "wrappers under the same harness)")
    ap.add_argument("--prefill-traces", action="store_true", help="run "
                    "only the profiled prefill steps of rwkv6-3b and "
                    "recurrentgemma-9b (with --src, another commit's "
                    "kernels and engine under the same harness)")
    ap.add_argument("--flash-sass", default=None, metavar="DIR",
                    help="run only the SASS comparison of the contiguous "
                    "flash kernels (K7/K14, K8, K9) with another tree's "
                    "unpacked src/ DIR")
    ap.add_argument("--src", default=None, help="the package root to run "
                    "(default: src/ beside this script; another commit's "
                    "unpacked src/ runs its kernels under this script's "
                    "checks)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU only",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(args.src) if args.src
                    else os.path.join(root, "src"))
    from repro_torch import resolve_device
    from repro_torch.kernels import build

    card = gpu_line()
    log(card)
    resolve_device("cuda")                      # pins TF32 off
    # the timing-only modes build just the libraries they run
    only = (("posit_codec",) if args.codec_times else
            ("recurrent_scan",) if args.scan_times else None)
    secs = build.build_all(only) if only else build.build_all()
    log(f"[build] {secs:.1f} s (nvcc, sm_90a, in parallel); "
        f"torch {torch.__version__} cuda {torch.version.cuda}; package "
        f"{os.path.dirname(build.__file__)}")

    s = Smoke(torch)
    s.details["gpu"] = card
    if args.rwkv_layers:
        s.check_rwkv_layers("rwkv6-3b", 2)
        log(json.dumps(s.details["rwkv6-3b_layers"]))
        return 0
    if args.skinny_times:
        s.time_skinny(SKINNY_ARCHS[:1] + SKINNY_ARCHS[2:])
        log(json.dumps({k: s.details[k] for k in ("pw_gemm_model_steps",
                                                  "pw_gemm_model_shapes")}))
        return 0
    if args.flash_sass:
        same = flash_sass_same(os.path.abspath(args.flash_sass))
        log(json.dumps(same))
        return 0 if all(not r["differ"] and r["instances"]
                        for r in same.values()) else 1
    if args.paged_times:
        log(json.dumps(s.time_paged(plain=False)))
        return 0
    if args.scan_times:
        log(json.dumps(s.time_scans(plain=False)))
        return 0
    if args.codec_times:
        log(json.dumps(s.time_codec(plain=False)))
        return 0
    if args.prefill_traces:
        s.prefill_traces()
        log(json.dumps({k: v for k, v in s.details.items()
                        if k.endswith("_prefill_trace")}))
        return 0
    if args.grouped_times:
        s.time_moe_kernels(plain=False)
        log(json.dumps({k: s.details[k] for k in ("moe_kernel_totals",
                                                  "moe_kernel_shapes")}))
        return 0
    regs = ptxas_report(build, "posit_gemm", ("gemm_mma_kernel",
                                              "splitk_reduce_kernel",
                                              "pw_skinny_kernel"))
    s.details["posit_gemm_ptxas"] = regs
    skinny = sorted(r["registers"] for r in regs
                    if r["kernel"] == "pw_skinny_kernel")
    tiled = sorted(r["registers"] for r in regs
                   if r["kernel"] != "pw_skinny_kernel")
    log(f"[build] posit_gemm: {len(tiled)} instances of the tiled kernel "
        f"and its split-K reduce, registers {tiled}; {len(skinny)} of the "
        f"skinny kernel, registers {skinny}; no spills")
    regs = ptxas_report(build, "grouped_gemm", GROUPED_KERNEL_SYMBOLS)
    s.details["grouped_gemm_ptxas"] = regs
    log("[build] grouped_gemm: " + ", ".join(
        f"{r['kernel']} {r['registers']}" for r in regs)
        + " registers, no spills")
    regs = ptxas_report(build, "flash_prefill", FLASH_KERNEL_SYMBOLS)
    s.details["flash_prefill_ptxas"] = regs
    log("[build] flash_prefill: " + ", ".join(
        f"{r['kernel']} {r['registers']}" for r in regs)
        + " registers, no spills")
    regs = ptxas_report(build, "paged_attention", ("paged_decode_kernel",))
    s.details["paged_attention_ptxas"] = regs
    log("[build] paged_attention: paged_decode_kernel registers "
        f"{sorted(r['registers'] for r in regs)}, no spills")
    regs = ptxas_report(build, "posit_codec", CODEC_KERNEL_SYMBOLS)
    s.details["posit_codec_ptxas"] = regs
    log("[build] posit_codec: " + ", ".join(
        f"{r['symbol']} {r['registers']}" for r in regs)
        + " registers, no spills")
    regs = ptxas_report(build, "recurrent_scan", ("wkv_scan_kernel",
                                                  "rglru_scan_kernel",
                                                  "rt_check_kernel"))
    s.details["recurrent_scan_ptxas"] = regs
    log("[build] recurrent_scan: " + ", ".join(
        f"{r['kernel']} {r['registers']}" for r in regs)
        + " registers, no spills")
    t0 = time.perf_counter()
    s.check_codec()
    s.check_append()
    s.check_gemm()
    s.check_gemm_edges()
    s.check_skinny()
    s.skinny_sass()
    s.check_attention()
    s.check_attention_smoke_layout()
    s.check_attention_bad_entries()
    log(f"[phase] kernel checks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s.time_kernels()
    s.time_skinny()
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
    for name in SERVING_KERNELS:
        s.record(name, launches=s.details["serving"]["launches"][name])
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
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    s.check_moe_kernels()
    torch.cuda.empty_cache()
    s.time_moe_kernels()
    torch.cuda.empty_cache()
    log(f"[phase] MoE kernels {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    qparams, cfg, reqs = s.serve("olmoe-1b-7b", key="moe_serving")
    s.record("grouped_gemm",
             launches=s.details["moe_serving"]["launches"]["grouped_gemm"])
    log(f"[phase] MoE serving {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s.trace_decode(qparams, cfg, reqs, key="moe_decode_trace")
    del qparams
    torch.cuda.empty_cache()
    log(f"[phase] MoE decode trace {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s.check_moe_logits()
    torch.cuda.empty_cache()
    log(f"[phase] MoE logits check {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s.train_moe_whole_step()
    torch.cuda.empty_cache()
    log(f"[phase] MoE training step check {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # depth 4 of 16: full depth's f32 training state is ~136 GB
    moe_leg = s.train_full("olmoe-1b-7b", legs=("p16",),
                           n_layers=MOE_TRAIN_LAYERS,
                           key="moe_training")["p16"]
    s.record("grouped_gemm_dw", launches=moe_leg["launches"][
        "grouped_gemm_dw"])
    torch.cuda.empty_cache()
    log(f"[phase] MoE training main path {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s.train_moe_deterministic()
    log(f"[phase] MoE determinism {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    s.check_round_trip()
    s.check_recurrent_kernels()
    s.check_attention_d256()
    s.check_flash_attention()
    torch.cuda.empty_cache()
    s.time_recurrent_kernels()
    torch.cuda.empty_cache()
    attn_launches = s.attention_entry()
    s.record("flash_attention", launches=attn_launches["flash_attention"])
    log(f"[phase] recurrent kernels {time.perf_counter() - t0:.1f} s")
    rec_launches = {}
    for arch, key, scan, extra in (
            ("rwkv6-3b", "rwkv_serving", "wkv_scan", 0),
            ("recurrentgemma-9b", "rg_serving", "rglru_scan", 2)):
        t0 = time.perf_counter()
        qparams, cfg, reqs = s.serve(arch, key=key, long_prompts=extra)
        rec_launches[scan] = s.details[key]["launches"][scan]
        s.record(scan, launches=rec_launches[scan])
        log(f"[phase] {arch} serving {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        s.trace_decode(qparams, cfg, reqs, key=f"{key}_trace")
        s.trace_prefill(qparams, cfg, reqs, key=f"{key}_prefill_trace")
        del qparams
        torch.cuda.empty_cache()
        log(f"[phase] {arch} decode and prefill traces "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s.check_recurrent_logits("rwkv6-3b", 2, gate=False)
    torch.cuda.empty_cache()
    s.check_rwkv_layers("rwkv6-3b", 2)
    torch.cuda.empty_cache()
    s.check_recurrent_logits("recurrentgemma-9b", 3)
    torch.cuda.empty_cache()
    s.check_smoke_drain("rwkv6-3b")
    s.check_smoke_drain("recurrentgemma-9b")
    log(f"[phase] recurrent output checks {time.perf_counter() - t0:.1f} s")

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
    # the training kernels right after the counted 8-step p16 run, K10 after
    # the counted MoE drain, K11 after the counted MoE training run, K12 and
    # K13 after the counted rwkv6 and recurrentgemma drains, K14 after the
    # counted ops.attention calls
    log("kernels: " + json.dumps({
        **s.details["serving"]["launches"], **arith_launches,
        **train_launches,
        "grouped_gemm": s.kernels["grouped_gemm"]["launches"],
        "grouped_gemm_dw": s.kernels["grouped_gemm_dw"]["launches"],
        **rec_launches, **attn_launches}))
    log("kernels (training main path, 8 p16 steps): "
        + json.dumps(legs["p16"]["launches"]))
    log("kernels (MoE serving main path, the drain): "
        + json.dumps(s.details["moe_serving"]["launches"]))
    log("kernels (MoE training main path, 8 p16 steps at depth "
        f"{MOE_TRAIN_LAYERS}): " + json.dumps(moe_leg["launches"]))
    log("kernels (rwkv6-3b serving main path, the drain): "
        + json.dumps(s.details["rwkv_serving"]["launches"]))
    log("kernels (recurrentgemma-9b serving main path, the drain): "
        + json.dumps(s.details["rg_serving"]["launches"]))
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
