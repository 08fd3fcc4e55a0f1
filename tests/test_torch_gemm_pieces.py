"""The arithmetic of K2's tensor-core kernel (`csrc/posit_gemm.cu`) on the
CPU: operands split exactly into bf16 pieces, a plain model of the kernel's
sums held against `repro`'s jnp oracle, and `gemm_plan` over every GEMM
shape the port's models launch.

The CUDA kernel runs only on the card (`chip_smoke.py` holds it against its
plain version there); these tests pin what its design rests on:

- bf16 round-to-nearest-even is emulated with int32 bit operations, as the
  card's `cvt.rn.bf16.f32` rounds; every posit8/posit16 pattern (es 0..3)
  is the sum of two pieces and a finite f32 of magnitude >= 2^-110 the sum
  of three (below, the residual stays under bf16's half subnormal step);
- the model sums the kept piece products of each 16-deep k chunk exactly
  and rounds once to f32 per product pair and chunk (one mma), in the
  kernel's order; posit forms stay within the f32 dot-product bound
  2 K 2^-24 (|a| @ |b|) of the oracle, f32 x f32 within that plus the
  declared 2^-22 (|a| @ |b|) of the three dropped products.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TINY = 2.0 ** -110             # f32 magnitudes that split exactly into 3
BF16_HALF_SUBNORMAL = 2.0 ** -134


def bf16_rn(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the f32 value of its bf16 round-to-nearest-even, by int32
    bit operations (NaN stays NaN; overflow rounds to Inf, as cvt.rn)."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    lsb = (u >> 16) & 1
    r = (u + 0x7FFF + lsb) & 0xFFFF0000
    r = torch.where(torch.isnan(x), torch.full_like(u, 0x7FC00000), r)
    return (r - ((r >> 31) << 32)).to(torch.int32).view(torch.float32)


def bf16_rz(x: torch.Tensor) -> torch.Tensor:
    u = x.view(torch.int32) & -65536                    # 0xFFFF0000
    return u.view(torch.float32)


def split(x: torch.Tensor, pieces: int) -> list[torch.Tensor]:
    """The kernel's split_pieces: x1 = bf16(x) (toward zero where it would
    overflow), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2); a non-finite x
    keeps x1 = x and zero pieces after it."""
    x1 = bf16_rn(x)
    over = torch.isinf(x1) & torch.isfinite(x)
    if pieces == 3:
        x1 = torch.where(over, bf16_rz(x), x1)
    out = [x1]
    r = torch.where(torch.isfinite(x), x - x1, torch.zeros_like(x))
    for _ in range(pieces - 1):
        p = bf16_rn(r)
        out.append(p)
        r = r - p
    return out


def _is_bf16(v: torch.Tensor) -> bool:
    return bool(((v.view(torch.int32) & 0xFFFF) == 0).all())


# ---- (a) exact splits ------------------------------------------------------
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("es", [0, 1, 2, 3])
def test_every_posit_pattern_splits_exactly_into_two_bf16(n, es):
    from repro_torch.core.types import PositConfig
    from repro_torch.kernels import ref
    cfg = PositConfig(n, es)
    dt = getattr(torch, cfg.storage_dtype_name)
    pats = torch.arange(-(1 << (n - 1)), 1 << (n - 1),
                        dtype=torch.int32).to(dt)
    x = ref.decode_ref(pats, cfg)
    fin = torch.isfinite(x)
    assert int((~fin).sum()) == 1                       # NaR only
    x1, x2 = split(x, 2)
    assert _is_bf16(x1) and _is_bf16(x2)
    assert torch.equal(x1[fin] + x2[fin], x[fin])       # f32 sum exact too
    assert torch.equal(x1[fin].double() + x2[fin].double(), x[fin].double())
    assert torch.isnan(x1[~fin]).all() and (x2[~fin] == 0).all()


def _f32_sweep(seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    rand = rng.integers(-2 ** 31, 2 ** 31, 1 << 20, dtype=np.int64)
    sub = np.arange(1, 1 << 23, 4099, dtype=np.int64)        # subnormals
    # ties: the 16 dropped bits exactly half a bf16 step, even and odd
    ties = (rng.integers(0, 1 << 15, 4096, dtype=np.int64) << 16) | 0x8000
    extremes = np.array([0x7F7FFFFF, 0x7F7F7FFF, 0x7F7F8000, 0x7F7F8001,
                         0x7F7F0000, 0x00800000, 0x00800001, 0x007FFFFF,
                         0x00000001, 0x08800000, 0x08FFFFFF, 0x3F800001,
                         0x3FFFFFFF, 0x3F7FFFFF, 0x7F800000, 0x7FC00000,
                         0], dtype=np.int64)
    bits = np.concatenate([rand, sub, ties, extremes])
    bits = np.concatenate([bits, bits | (1 << 31)])          # both signs
    return torch.from_numpy(bits.astype(np.uint32).view(np.int32)).view(
        torch.float32)


def test_f32_sweep_splits_exactly_into_three_bf16():
    x = _f32_sweep()
    x1, x2, x3 = split(x, 3)
    for p in (x1, x2, x3):
        assert _is_bf16(p)
    fin = torch.isfinite(x)
    assert torch.isfinite(x1[fin]).all()                     # no overflow
    big = fin & (x.abs() >= TINY)
    s = x1.double() + x2.double() + x3.double()
    assert int(big.sum()) > 1_000_000
    assert torch.equal(s[big], x[big].double())
    small = fin & ~big
    assert int(small.sum()) > 1000
    assert float((s[small] - x[small].double()).abs().max()) \
        <= BF16_HALF_SUBNORMAL
    assert torch.equal(x1[~fin].isnan(), x[~fin].isnan())
    assert (x2[~fin] == 0).all() and (x3[~fin] == 0).all()
    # the pieces shrink as the source's bound on the dropped terms uses
    xb, ab = x[big].double().abs(), [p[big].double().abs()
                                     for p in (x1, x2, x3)]
    assert bool((ab[1] <= 2.0 ** -8 * (1 + 2.0 ** -8) * xb).all())
    assert bool((ab[2] <= 2.0 ** -16 * xb).all())


def test_bf16_rn_emulation_matches_torch_rounding():
    """The int32 emulation agrees with torch's own f32 -> bf16 RNE cast on
    finite values (both round half to even)."""
    x = _f32_sweep(1)
    fin = torch.isfinite(x) & (x.abs() < 3.38e38)
    want = x[fin].to(torch.bfloat16).to(torch.float32)
    assert torch.equal(bf16_rn(x)[fin].view(torch.int32),
                       want.view(torch.int32))


# ---- (b) a plain model of the kernel's arithmetic vs repro's oracle --------
def piece_pairs(pa: int, pb: int) -> list[tuple[int, int]]:
    """The cross products in the kernel's order: A piece by piece from the
    smallest, then B's from the smallest (x1 y1 is summed on its own;
    f32 x f32 drops the three with i + j > 2)."""
    return [(i, j) for i in range(pa - 1, -1, -1)
            for j in range(pb - 1, -1, -1)
            if i + j > 0 and not (pa == pb == 3 and i + j > 2)]


def kernel_model(af: torch.Tensor, bf: torch.Tensor, pa: int,
                 pb: int) -> torch.Tensor:
    """[M, K] x [K, N] as the tensor-core kernel sums them.  Per 16-deep k
    chunk: each cross product's 16 products added exactly to the f32
    accumulator with one rounding (one mma), in `piece_pairs` order; then
    x1 y1's 16 products summed exactly, rounded once (an mma from zero) and
    added with one more rounding."""
    A, B = split(af, pa), split(bf, pb)
    M, K = af.shape
    acc = torch.zeros((M, bf.shape[1]), dtype=torch.float32)
    for k0 in range(0, K, 16):
        for i, j in piece_pairs(pa, pb):
            part = A[i][:, k0:k0 + 16].double() @ B[j][k0:k0 + 16].double()
            acc = (acc.double() + part).to(torch.float32)
        big = (A[0][:, k0:k0 + 16].double()
               @ B[0][k0:k0 + 16].double()).to(torch.float32)
        acc = acc + big
    return acc


def test_piece_pairs_order_and_count():
    assert piece_pairs(2, 2) == [(1, 1), (1, 0), (0, 1)]
    assert piece_pairs(3, 2) == [(2, 1), (2, 0), (1, 1), (1, 0), (0, 1)]
    assert piece_pairs(3, 3) == [(2, 0), (1, 1), (1, 0), (0, 2), (0, 1)]
    assert piece_pairs(2, 3) == [(1, 2), (1, 1), (1, 0), (0, 2), (0, 1)]
    # with x1 y1: 4 products for posit x posit, 6 for f32 x posit and for
    # f32 x f32 (of 9)
    assert [len(piece_pairs(*p)) + 1 for p in ((2, 2), (3, 2), (2, 3),
                                               (3, 3))] == [4, 6, 6, 6]


def test_kernel_model_k1_is_the_product_rounded_once():
    """At K = 1 the x1 y1 product is exact and the cross products are
    2^-8 of it: the model rounds the exact product once, as an f32
    multiply does, up to the cross terms' own roundings."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((64, 1)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1, 48)).astype(np.float32))
    got = kernel_model(a, b, 3, 3).double()
    exact = a.double() @ b.double()
    ulp = torch.from_numpy(np.spacing(np.abs(exact.numpy()).astype(
        np.float32)).astype(np.float64))
    assert bool(((got - exact).abs() <= 0.5 * ulp + 2.0 ** -22
                 * exact.abs()).all())
    assert bool(((got - (a @ b).double()).abs() <= ulp).all())


FORMATS = ["f32", "p8", "p16"]


@pytest.mark.parametrize("K", [1, 7, 16, 17, 33])
@pytest.mark.parametrize("fa,fb", [(a, b) for a in FORMATS for b in FORMATS])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_kernel_model_within_bound_of_reference(K, fa, fb, ta, tb):
    import jax.numpy as jnp
    from repro.core.convert import f32_to_posit
    from repro.core.types import P8_2, P16_2
    from repro.kernels.ref import posit_gemm_ref
    from repro_torch.kernels import ref as port_ref
    from torch_parity import port_posit
    M, N = 9, 13
    rng = np.random.default_rng(K * 100 + FORMATS.index(fa) * 10
                                + FORMATS.index(fb) + 2 * ta + tb)
    ref_cfgs = {"f32": None, "p8": P8_2, "p16": P16_2}

    def operand(fmt, rows, cols, scale):
        x = (rng.standard_normal((rows, cols)) * scale).astype(np.float32)
        cfg = ref_cfgs[fmt]
        if cfg is None:
            return x, x, None
        bits = np.asarray(f32_to_posit(jnp.asarray(x), cfg))
        val = port_ref.decode_ref(torch.from_numpy(bits),
                                  port_posit(cfg)).numpy()
        return bits, val, cfg

    a_st, a_val, ca = operand(fa, *((K, M) if ta else (M, K)), 1.0)
    b_st, b_val, cb = operand(fb, *((N, K) if tb else (K, N)), K ** -0.5)
    A = a_val.T if ta else a_val                       # [M, K] values
    B = b_val.T if tb else b_val                       # [K, N] values
    # the oracle takes A [M, K] (no transpose_a) and B as stored
    a_in = np.ascontiguousarray(a_st.T) if ta else a_st
    want = np.asarray(posit_gemm_ref(jnp.asarray(a_in), jnp.asarray(b_st),
                                     cfg_a=ca, cfg_b=cb, transpose_b=tb))
    got = kernel_model(torch.from_numpy(np.ascontiguousarray(A)),
                       torch.from_numpy(np.ascontiguousarray(B)),
                       3 if ca is None else 2, 3 if cb is None else 2)
    s = np.abs(A).astype(np.float64) @ np.abs(B).astype(np.float64)
    tol = 2 * K * 2.0 ** -24 * s
    if ca is None and cb is None:
        tol += 2.0 ** -22 * s                          # declared in the source
    diff = np.abs(got.numpy().astype(np.float64) - want.astype(np.float64))
    assert diff.shape == (M, N)
    assert bool((diff <= tol).all()), float((diff / (tol + 1e-300)).max())
    if ca is not None or cb is not None:
        # exact products: the model equals an f32 sum of the decoded values
        # as closely as two summation orders allow, and posit out rounds
        # its own accumulator once
        cfg_out = port_posit(ref_cfgs["p16"])
        pos = port_ref.encode_ref(got, cfg_out)
        lo = port_ref.encode_ref(torch.from_numpy(
            (want - tol).astype(np.float32)), cfg_out).int()
        hi = port_ref.encode_ref(torch.from_numpy(
            (want + tol).astype(np.float32)), cfg_out).int()
        assert bool(((lo <= pos.int()) & (pos.int() <= hi)).all())


def test_kernel_model_f32_dropped_terms_stay_inside_declared_term():
    """With the dropped products the only difference (one exact sum, no
    chunk roundings), the f32 x f32 model moves by less than
    2^-22 (|a| @ |b|) from the exact product."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 12)).astype(np.float32))
    A, B = split(a, 3), split(b, 3)
    kept = sum(A[i].double() @ B[j].double() for i in range(3)
               for j in range(3) if i + j <= 2)
    exact = a.double() @ b.double()
    s = a.abs().double() @ b.abs().double()
    assert bool(((kept - exact).abs() <= 2.0 ** -22 * s).all())
    assert float(((kept - exact).abs() / s).max()) > 0      # terms dropped


# ---- (c) the launch plan -------------------------------------------------------
H100_SMEM = 232_448           # dynamic shared bytes a block may opt into
H100_THREADS = 1024
TRAIN_TOKENS = 8 * 512        # chip_smoke's training batch
PREFILL_ROWS = 8 * 128        # max_seqs x prefill_chunk


def _gemm_weights(arch, monkeypatch):
    """(name, shape) of every 2-D weight the full-width model multiplies
    through K2 ("w" linears, the tied "table", the MoE "router"), from an
    init whose random tables are meta tensors (no memory)."""
    from repro_torch import configs
    from repro_torch.models import blocks, griffin, moe, rwkv6, transformer

    def meta(gen, shape, scale):
        return torch.empty(shape, device="meta")

    for mod in (blocks, griffin, moe, rwkv6):
        monkeypatch.setattr(mod, "_normal", meta)
    cfg = configs.get_config(arch)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    out = []

    def walk(t, name=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, k)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v, name)
        elif name in ("w", "table", "router") and t.ndim == 2:
            out.append((name, tuple(t.shape)))

    walk(params)
    return out


def _serving_shapes(weights):
    """(M, N, K, kinds, transpose_a, transpose_b) of a prefill step's
    tiled GEMMs (decode steps run the skinny kernels, and the MoE router's
    f32 posit_gemm at M = 8 and at prefill)."""
    shapes = set()
    for name, (r, c) in weights:
        if name == "router":
            for M in (8, PREFILL_ROWS):
                shapes.add((M, c, r, ("f32", "f32"), False, False))
        elif name == "table":
            shapes.add((PREFILL_ROWS, r, c, ("f32", "posit"), False, True))
        else:
            shapes.add((PREFILL_ROWS, c, r, ("f32", "posit"), False, False))
    return shapes


def _training_shapes(weights, T=TRAIN_TOKENS):
    """Forward, dX and dW (transpose_a) of every trained weight, f32."""
    f = ("f32", "f32")
    shapes = set()
    for name, (r, c) in weights:
        if name == "table":                            # [V, d], transpose_b
            shapes |= {(T, r, c, f, False, True), (T, c, r, f, False, False),
                       (r, c, T, f, True, False)}
        else:                                          # [K, N]
            shapes |= {(T, c, r, f, False, False), (T, r, c, f, False, True),
                       (r, c, T, f, True, False)}
    return shapes


def _edge_shapes():
    """chip_smoke's GEMM checks: edge shapes, the quire and the dW leg."""
    shapes = set()
    for M in (9, 24, 129):
        for K in (1, 7, 33):
            for kinds in [(x, y) for x in ("f32", "posit")
                          for y in ("f32", "posit")]:
                for ta in (False, True):
                    for tb in (False, True):
                        shapes.add((M, 100, K, kinds, ta, tb))
    for K, N in ((960, 960), (960, 2560), (2560, 960)):
        shapes.add((1024, N, K, ("posit", "posit"), False, False))
    shapes.add((1024, 2560, 960, ("posit", "posit"), False, True))
    for M, N in ((960, 960), (960, 320), (960, 2560), (2560, 960),
                 (49152, 960)):
        shapes.add((M, N, 4096, ("f32", "f32"), True, False))
    shapes.add((960, 320, 4096, ("posit", "f32"), True, False))
    return shapes


def _check_plan(M, N, K, kinds, ta, tb):
    from repro_torch.kernels import posit_gemm as G
    p = G.gemm_plan(M, N, K, kinds, ta, tb)
    assert p.threads <= H100_THREADS and p.threads % 32 == 0
    assert 0 < p.smem <= H100_SMEM
    assert (p.bm, p.bn) in [(t[0], t[1]) for t in G.TILES]
    assert p.threads == 32 * [t[2] * t[3] for t in G.TILES
                              if (t[0], t[1]) == (p.bm, p.bn)][0]
    nk = -(-max(K, 1) // G.BK)
    assert 1 <= p.splits <= G.MAX_SPLITS
    # the slices cover the k-tiles, none empty
    assert (p.splits - 1) * p.per < nk <= p.splits * p.per
    if p.splits > 1:
        assert p.per >= G.MIN_SLICE_TILES
    blocks = -(-M // p.bm) * -(-N // p.bn) * p.splits
    # a wave of blocks (at least 9 SMs in 10 busy at one block each), or
    # split-K, or too few k-tiles to split
    assert (10 * blocks >= 9 * G.SMS or p.splits > 1
            or nk < 2 * G.MIN_SLICE_TILES), (M, N, K, p)
    return p


@pytest.mark.parametrize("arch", ["smollm-360m", "olmoe-1b-7b", "rwkv6-3b",
                                  "recurrentgemma-9b"])
def test_gemm_plan_fits_every_served_shape(arch, monkeypatch):
    shapes = _serving_shapes(_gemm_weights(arch, monkeypatch))
    assert shapes
    for shape in shapes:
        _check_plan(*shape)


@pytest.mark.parametrize("arch", ["smollm-360m", "olmoe-1b-7b"])
def test_gemm_plan_fits_every_trained_shape(arch, monkeypatch):
    shapes = _training_shapes(_gemm_weights(arch, monkeypatch))
    splits = [_check_plan(*s).splits for s in shapes]
    assert max(splits) <= 8


def test_gemm_plan_edge_and_check_shapes():
    from repro_torch.kernels import posit_gemm as G
    for shape in _edge_shapes():
        _check_plan(*shape)
    # the dW leg of smollm's step: split-K where 128 x 128 tiles leave SMs
    # idle (under one wave, or 160 tiles: a 28-block second wave), none at
    # the table's 3,072 tiles
    got = {(M, N): G.gemm_plan(M, N, 4096, ("f32", "f32"), True)
           for M, N in ((960, 960), (960, 320), (960, 2560), (2560, 960),
                        (49152, 960))}
    assert {k: (p.bm, p.splits) for k, p in got.items()} == {
        (960, 960): (128, 2), (960, 320): (128, 5), (960, 2560): (128, 4),
        (2560, 960): (128, 4), (49152, 960): (128, 1)}
    # shared bytes follow the pieces: f32 operands take 3 planes, posits 2
    p16 = G.gemm_plan(1024, 960, 960, ("posit", "posit"))
    f32 = G.gemm_plan(1024, 960, 960, ("f32", "f32"))
    assert (p16.bm, p16.bn) == (f32.bm, f32.bn)
    assert 2 * f32.smem == 3 * p16.smem


def test_wrappers_count_split_k_reduce_only_on_launch():
    """On the CPU the wrappers run their plain versions: no launch, no
    reduce counted, whatever the plan."""
    from repro_torch.core.types import P16_2
    from repro_torch.kernels import ops
    from repro_torch.kernels import posit_gemm as G
    from repro_torch.kernels import ref
    ops.reset_counters()
    a = torch.randn(64, 4096)
    g = torch.randn(64, 320)
    assert G.gemm_plan(4096, 320, 64, ("f32", "f32"), True).splits == 1
    G.posit_gemm(a, g, cfg_a=None, cfg_b=None, transpose_a=True)
    w = ref.encode_ref(torch.randn(960, 320), P16_2)
    G.pw_gemm(torch.randn(24, 960), w, P16_2)
    counts, plain = ops.launch_counts(), ops.plain_counts()
    assert counts["posit_gemm_reduce"] == counts["pw_gemm_reduce"] == 0
    assert counts["posit_gemm"] == counts["pw_gemm"] == 0
    assert plain["posit_gemm"] == plain["pw_gemm"] == 1
