"""K2's skinny form (`pw_gemm` at M <= 8, `csrc/posit_gemm.cu`
`pw_skinny_kernel`) on the CPU: its decode, its launch plan and its
summation order.

The CUDA kernel runs only on the card (`chip_smoke.py` holds it against its
plain version there, bit for bit over every pattern at K = 1); these tests
pin what its design rests on:

- the decode per format, emulated with the kernel's own integer steps: the
  P16_2 table of regime scales and rotations with its flagged fallback, the
  posit8 table built by `posit_decode`, and `posit_decode` for every other
  int16 format, each equal to `ref.decode_ref` on every pattern;
- `skinny_plan` (the mirror of `make_skinny_plan`) fits the card at every
  served decode shape of the four models and at the card checks' shapes;
- a plain model of the kernel's fixed summation order stays within the f32
  dot-product bound 2 K 2^-24 (|x| @ |w|) of `repro`'s jnp oracle.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_gemm_pieces import _gemm_weights  # noqa: E402

U32 = 0xFFFFFFFF


# ---- (a) the decode, as the kernel computes it -----------------------------
def _bitlen(y: np.ndarray) -> np.ndarray:
    out = np.zeros_like(y)
    v = y.copy()
    while (v > 0).any():
        out += v > 0
        v >>= 1
    return out


def posit_decode_emul(p: np.ndarray, n: int, es: int) -> np.ndarray:
    """`posit_codec.cuh::posit_decode` step by step on int64 lanes ->
    f32 bits (uint32)."""
    mask = (1 << n) - 1
    u = p.astype(np.int64) & mask
    s = u >> (n - 1)
    a = np.where(s == 1, (0 - u) & mask, u)
    x = (a << 1) & mask
    b = x >> (n - 1)
    y = np.where(b == 1, ~x & mask, x)
    run = np.minimum(n - _bitlen(y), n - 1)
    k = np.where(b == 1, run - 1, -run)
    rem = (x << (run + 1)) & mask
    e = rem >> (n - es) if es > 0 else np.zeros_like(rem)
    frac = (rem << es) & mask if es > 0 else rem
    te = k * (1 << es) + e
    mant23 = (frac >> 3) << (23 - (n - 3))
    f = ((s << 31) | ((te + 127) << 23) | mant23) & U32
    f = np.where(u == 0, 0, f)
    f = np.where(u == 1 << (n - 1), 0x7FC00000, f)
    return f.astype(np.uint32)


SLOW = 0x800


def p16e2_table() -> np.ndarray:
    """`p16e2_entry` for every i = a[30:23]."""
    ent = np.zeros(256, np.int64)
    for i in range(256):
        r0 = i >> 7
        y = (~i & 0xFF) if r0 else i
        if y == 0 or i == 0xFE:
            ent[i] = SLOW
            continue
        run = 8 - y.bit_length()
        S = run + 2
        k = run - 1 if r0 else -run
        top = i >> (9 - S)
        regime = (top if S <= 7 else top & 0x7F) << 25
        ent[i] = (((4 * k + 127) << 23) - regime + ((S + 25) & 31)) & U32
    return ent


def p16e2_decode_emul(p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's P16_2 decode of int16 patterns: the fast path
    ((rotl(a, e) + e) & 0x7FFFF000) | sign, and posit_decode where the entry
    is flagged.  Returns (f32 bits, flagged)."""
    tab = p16e2_table()
    xi = ((p.astype(np.int64) & 0xFFFF) << 16) & U32
    a = np.where(xi >= 1 << 31, ((1 << 32) - xi) & U32, xi)   # abs.s32
    e = tab[(a >> 23) & 0xFF]
    rot = e & 31
    r = ((a << rot) | (a >> (32 - rot))) & U32                 # rotl
    fast = (((r + e) & 0x7FFFF000) | (xi & 0x80000FFF)) & U32
    slow = (e & SLOW) != 0
    out = np.where(slow, posit_decode_emul(p, 16, 2), fast)
    return out.astype(np.uint32), slow


def _ref_bits(p: np.ndarray, n: int, es: int) -> np.ndarray:
    from repro_torch.core.types import PositConfig
    from repro_torch.kernels import ref
    cfg = PositConfig(n, es)
    dt = getattr(torch, cfg.storage_dtype_name)
    v = ref.decode_ref(torch.from_numpy(p).to(dt), cfg)
    return v.view(torch.int32).numpy().view(np.uint32)


def _all_patterns(n: int) -> np.ndarray:
    return np.arange(-(1 << (n - 1)), 1 << (n - 1), dtype=np.int64)


def _same_bits(got: np.ndarray, want: np.ndarray) -> None:
    gnan = np.isnan(got.view(np.float32))
    wnan = np.isnan(want.view(np.float32))
    assert (gnan == wnan).all()
    assert wnan.sum() == 1                                   # NaR only
    assert (got[~wnan] == want[~wnan]).all(), int((got != want).sum())


def test_p16e2_fast_decode_every_pattern():
    p = _all_patterns(16)
    got, slow = p16e2_decode_emul(p)
    _same_bits(got, _ref_bits(p, 16, 2))
    # the fallback takes 0, NaR, |w| < 2^-28 and |w| >= 2^24 and nothing
    # else: the fast path alone equals the reference everywhere else
    v = _ref_bits(p, 16, 2).view(np.float32)
    mag = np.abs(v.astype(np.float64))
    expect = (mag == 0) | np.isnan(v) | (mag < 2.0 ** -28) | (mag >= 2.0 ** 24)
    assert (slow == expect).all()
    assert slow.sum() == 2 + 2 * 127 + 2 * (2 * 128)


def test_p16e2_table_entries():
    """Rotation in bits 4:0, bits 11:5 clear (they never reach a value),
    the flag only on 0x00, 0xFE and 0xFF."""
    tab = p16e2_table()
    flagged = [i for i in range(256) if tab[i] & SLOW]
    assert flagged == [0x00, 0xFE, 0xFF]
    ok = np.array([i not in flagged for i in range(256)])
    assert ((tab[ok] >> 5) & 0x7F == 0).all()
    assert set((tab[ok] & 31).tolist()) <= {28, 29, 30, 31, 0, 1, 2}


@pytest.mark.parametrize("es", [0, 1, 2, 3])
def test_posit8_table_every_pattern(es):
    """int8 storage: the kernel's 256-entry table is posit_decode of each
    byte; one load per element, no fallback."""
    table = posit_decode_emul(np.arange(256, dtype=np.int64), 8, es)
    p = _all_patterns(8)
    got = table[p & 0xFF]
    _same_bits(got, _ref_bits(p, 8, es))


@pytest.mark.parametrize("es", [0, 1, 2, 3])
def test_posit16_runtime_decode_every_pattern(es):
    """Every int16 format but P16_2 runs posit_decode with its runtime
    (n, es); P16_2's is the fast path's fallback."""
    p = _all_patterns(16)
    _same_bits(posit_decode_emul(p, 16, es), _ref_bits(p, 16, es))


# ---- (b) the plan ------------------------------------------------------------
H100_SMEM = 232_448
ARCHS = ["smollm-360m", "olmoe-1b-7b", "rwkv6-3b", "recurrentgemma-9b"]


def _decode_shapes(weights):
    """(N, K, transpose_b) of a decode step's pw_gemm calls: the "w"
    linears [K, N] and the tied table [V, d] (the router is f32 and goes
    through posit_gemm)."""
    shapes = set()
    for name, (r, c) in weights:
        if name == "table":
            shapes.add((r, c, True))
        elif name == "w":
            shapes.add((c, r, False))
    return shapes


def _check_shapes():
    """chip_smoke's skinny checks: the edge grid and the exhaustive
    decode's K = 1 layouts."""
    shapes = {(M, N, K, tb) for M in (1, 3, 8) for N in (1, 100, 1000)
              for K in (1, 7, 33, 4096) for tb in (False, True)}
    for M in (1, 8):
        shapes |= {(M, 65536, 1, False), (M, 65536, 1, True),
                   (M, 256, 1, False), (M, 256, 1, True)}
    return shapes


def _check_skinny_plan(M, N, K, tb, eb, served=False):
    from repro_torch.kernels import posit_gemm as G
    p = G.skinny_plan(M, N, K, tb, eb)
    assert p.threads == G.SK_THREADS <= 1024
    assert p.tn * p.tk == p.threads
    assert p.bm in (4, 8) and p.bm >= M
    assert 0 < p.smem and p.smem + G.SK_TAB_BYTES <= H100_SMEM
    assert 1 <= p.splits <= G.SK_MAX_CLUSTER
    assert p.bn == p.tn * (4 if tb else 16 // eb)
    assert p.kpg == (16 // eb if tb else 1)
    assert (p.tiles - 1) * p.bn < N <= p.tiles * p.bn
    # the ranks' slices cover the k-groups, none empty
    ng = -(-max(K, 1) // p.kpg)
    assert (p.splits - 1) * p.per < ng <= p.splits * p.per
    assert (p.nch - 1) * p.chunk < p.per <= p.nch * p.chunk
    assert p.chunk * p.kpg * p.bm * 4 <= G.SK_XS_BYTES
    assert p.grid % p.splits == 0 and p.grid // p.splits <= p.tiles
    if served:
        # a wave of blocks on the card's SMs, or a k-split over a cluster
        assert p.grid >= G.SMS or p.splits > 1, (N, K, tb, p)
    return p


@pytest.mark.parametrize("arch", ARCHS)
def test_skinny_plan_fits_every_served_decode_shape(arch, monkeypatch):
    shapes = _decode_shapes(_gemm_weights(arch, monkeypatch))
    assert shapes
    for N, K, tb in shapes:
        for M in (1, 3, 8):
            for eb in (1, 2):
                _check_skinny_plan(M, N, K, tb, eb, served=True)


def test_skinny_plan_check_shapes():
    for M, N, K, tb in _check_shapes():
        for eb in (1, 2):
            _check_skinny_plan(M, N, K, tb, eb)


def test_skinny_plan_spreads_small_layers_over_clusters():
    """smollm's narrow layers take every cluster size they need: N = 320
    and 960 alone would leave most SMs idle."""
    from repro_torch.kernels import posit_gemm as G
    for K, N in ((960, 320), (960, 960), (2560, 960)):
        p = G.skinny_plan(8, N, K)
        assert p.splits == G.SK_MAX_CLUSTER and p.grid >= 160, p
    # the unembedding's thousands of tiles need no k-split across blocks
    # to fill the card
    p = G.skinny_plan(8, 256000, 4096, True)
    assert p.tiles >= 1000 and p.splits == 1 and p.grid >= G.SMS


# ---- (c) the summation order ------------------------------------------------
def _fma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 acc + a * b with the product exact (f64; x has 24 significant
    bits, a posit16 at most 12) and one rounding of the sum to f32 (as
    FFMA, up to a double rounding the bound check does not see)."""
    return (acc.double() + a.double() * b.double()).to(torch.float32)


def skinny_model(x: torch.Tensor, wf: torch.Tensor, plan) -> torch.Tensor:
    """x [M, K] @ wf [K, N] (decoded values) summed as the kernel sums:
    each lane (k-lane tk of a rank's chunk) by FFMA over its groups
    g0 + tk, g0 + tk + TK, ... in increasing k; the lanes of a column as
    p[i] + p[i + TK/2], added over i from 0; the ranks in rank order; the
    chunks into the output in chunk order."""
    M, K = x.shape
    N = wf.shape[1]
    ng = -(-max(K, 1) // plan.kpg)
    half = plan.tk // 2
    out = None
    for c in range(plan.nch):
        total = torch.zeros((M, N), dtype=torch.float32)
        for r in range(plan.splits):
            s0 = r * plan.per
            s1 = min(ng, s0 + plan.per)
            g0 = s0 + c * plan.chunk
            g1 = min(s1, g0 + plan.chunk)
            lanes = []
            for tk in range(plan.tk):
                acc = torch.zeros((M, N), dtype=torch.float32)
                for g in range(g0 + tk, g1, plan.tk):
                    for j in range(plan.kpg):
                        k = g * plan.kpg + j
                        if k < K:
                            acc = _fma(acc, x[:, k:k + 1], wf[k:k + 1, :])
                lanes.append(acc)
            block = torch.zeros((M, N), dtype=torch.float32)
            for i in range(half):
                block = block + (lanes[i] + lanes[i + half])
            total = total + block
        out = total if c == 0 else out + total
    return out


@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("fmt", ["p8", "p16"])
@pytest.mark.parametrize("K,N,tb", [(120, 40, False), (320, 120, False),
                                    (1120, 320, False), (120, 512, True),
                                    (320, 256, True), (33, 100, True)])
def test_skinny_order_within_bound_of_reference(M, fmt, K, N, tb):
    """smollm's, rwkv6's and recurrentgemma's decode widths scaled down by
    8-16 (and an edge), through the plan the kernel would take there."""
    import jax.numpy as jnp
    from repro.core.convert import f32_to_posit
    from repro.core.types import P8_2, P16_2
    from repro.kernels.ref import posit_gemm_ref
    from repro_torch.kernels import posit_gemm as G
    from repro_torch.kernels import ref as port_ref
    from torch_parity import port_posit
    ref_cfg = {"p8": P8_2, "p16": P16_2}[fmt]
    rng = np.random.default_rng(K + N + M + tb)
    x = rng.standard_normal((M, K)).astype(np.float32)
    wshape = (N, K) if tb else (K, N)
    w = (rng.standard_normal(wshape) * K ** -0.5).astype(np.float32)
    bits = np.array(f32_to_posit(jnp.asarray(w), ref_cfg))
    wf = port_ref.decode_ref(torch.from_numpy(bits), port_posit(ref_cfg))
    wkn = wf.T.contiguous() if tb else wf
    plan = G.skinny_plan(M, N, K, tb, bits.dtype.itemsize)
    got = skinny_model(torch.from_numpy(x), wkn, plan)
    want = np.asarray(posit_gemm_ref(jnp.asarray(x), jnp.asarray(bits),
                                     cfg_a=None, cfg_b=ref_cfg,
                                     transpose_b=tb))
    s = np.abs(x).astype(np.float64) @ np.abs(wkn.numpy()).astype(np.float64)
    tol = 2 * K * 2.0 ** -24 * s
    diff = np.abs(got.numpy().astype(np.float64) - want.astype(np.float64))
    assert diff.shape == (M, N)
    assert bool((diff <= tol).all()), float((diff / (tol + 1e-300)).max())


def test_skinny_model_k1_is_the_decoded_weight():
    """At K = 1 and x = 1 every output is the weight itself: the exhaustive
    decode check on the card rests on this."""
    from repro_torch.core.types import P16_2
    from repro_torch.kernels import posit_gemm as G
    from repro_torch.kernels import ref
    p = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16)
    wf = ref.decode_ref(p, P16_2)[None, :]
    plan = G.skinny_plan(1, wf.shape[1], 1)
    got = skinny_model(torch.ones((1, 1)), wf, plan)
    fin = torch.isfinite(wf)
    assert torch.equal(got[fin].view(torch.int32), wf[fin].view(torch.int32))
    assert torch.isnan(got[~fin]).all()


# ---- (d) the CPU wrapper ----------------------------------------------------
@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("tb", [False, True])
def test_pw_gemm_cpu_runs_plain_and_counts_no_launch(M, tb):
    from repro_torch.core.types import P16_2
    from repro_torch.kernels import ops
    from repro_torch.kernels import posit_gemm as G
    from repro_torch.kernels import ref
    ops.reset_counters()
    w = ref.encode_ref(torch.randn((100, 33) if tb else (33, 100)), P16_2)
    x = torch.randn(M, 33)
    got = G.pw_gemm(x, w, P16_2, transpose_b=tb)
    want = G.pw_gemm_plain(x, w, P16_2, tb)
    assert torch.equal(got, want)
    counts, plain = ops.launch_counts(), ops.plain_counts()
    assert counts["pw_gemm"] == counts["pw_gemm_reduce"] == 0
    assert plain["pw_gemm"] == 2
