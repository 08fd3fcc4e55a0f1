"""The port's posit arithmetic (core/ops.py, core/recip.py, core/quire.py,
core/packing.py and the plain versions of the elementwise/divide kernels)
against the JAX reference: repro.core.ops, the numpy golden model
repro.core.golden, and the reference's own Pallas kernels in interpret
mode.  Integer results must agree bit for bit: no tolerance."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def _cfgs(n, es):
    from repro.core.types import PositConfig as RefCfg
    from repro_torch.core.types import PositConfig
    return RefCfg(n, es), PositConfig(n, es)


def _p8_pairs():
    bits = np.arange(256)
    A, B = np.meshgrid(bits, bits)
    return A.ravel(), B.ravel()


def _sample(n, count, seed, k=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 1 << n, count) for _ in range(k))


def _masked(x, cfg) -> np.ndarray:
    return np.asarray(x).astype(np.int64) & cfg.mask


def _both(op, cfg_pair, *operands, **kw):
    """The reference's jnp op and the port's torch op on the same int32
    patterns -> both results as n-bit patterns (int64)."""
    import jax.numpy as jnp
    from repro.core import ops as RO
    from repro_torch.core import ops as TO
    ref_cfg, cfg = cfg_pair
    want = getattr(RO, op)(*(jnp.asarray(x, jnp.int32) for x in operands),
                           ref_cfg, **kw)
    got = getattr(TO, op)(*(torch.from_numpy(np.asarray(x, np.int32))
                            for x in operands), cfg, **kw)
    return _masked(got.numpy(), cfg), _masked(want, cfg)


DIV_CASES = [(m, nr) for m in ("exact", "poly", "poly_corrected", "pacogen")
             for nr in (0, 1)]


# --------------------------------------------------------------------------
# every posit8 pair, against repro.core.ops and the golden model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("es", [0, 2], ids=["P8_0", "P8_2"])
@pytest.mark.parametrize("op", ["padd", "psub", "pmul", "plt", "peq"])
def test_p8_binary_ops_every_pair(es, op):
    from repro.core import golden as G
    pair = _cfgs(8, es)
    A, B = _p8_pairs()
    got, want = _both(op, pair, A, B)
    np.testing.assert_array_equal(got, want)
    if op in ("padd", "psub", "pmul"):
        np.testing.assert_array_equal(got, getattr(G, op)(A, B, pair[0]))


@pytest.mark.parametrize("es", [0, 2], ids=["P8_0", "P8_2"])
@pytest.mark.parametrize("mode,nr", DIV_CASES)
def test_p8_divide_every_pair(es, mode, nr):
    from repro.core import golden as G
    pair = _cfgs(8, es)
    A, B = _p8_pairs()
    got, want = _both("pdiv", pair, A, B, mode=mode, nr_rounds=nr)
    np.testing.assert_array_equal(got, want)
    if mode in ("exact", "poly_corrected"):
        np.testing.assert_array_equal(got, G.pdiv(A, B, pair[0]))


@pytest.mark.parametrize("es", [0, 2], ids=["P8_0", "P8_2"])
@pytest.mark.parametrize("op", ["pneg", "pabs", "precip"])
def test_p8_unary_ops_every_pattern(es, op):
    from repro.core import golden as G
    pair = _cfgs(8, es)
    bits = np.arange(256)
    got, want = _both(op, pair, bits)
    np.testing.assert_array_equal(got, want)
    if op in ("pneg", "precip"):
        np.testing.assert_array_equal(got, getattr(G, op)(bits, pair[0]))


def test_p8_fma_sampled_triples():
    """2^20 seeded PFMADD triples at posit8 es2."""
    from repro.core import golden as G
    pair = _cfgs(8, 2)
    A, B, C = _sample(8, 1 << 20, seed=11, k=3)
    got, want = _both("pfma", pair, A, B, C)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, G.pfma(A, B, C, pair[0]))


@pytest.mark.slow
@pytest.mark.parametrize("es", range(5))
def test_p8_fma_every_triple(es):
    """Every posit8 PFMADD triple (16.7M), against the golden model."""
    from repro.core import golden as G
    from repro_torch.core.ops import pfma
    ref_cfg, cfg = _cfgs(8, es)
    A, B = _p8_pairs()
    for c in range(256):
        C = np.full(A.shape, c)
        got = pfma(torch.from_numpy(A.astype(np.int32)),
                   torch.from_numpy(B.astype(np.int32)),
                   torch.from_numpy(C.astype(np.int32)), cfg)
        np.testing.assert_array_equal(_masked(got.numpy(), cfg),
                                      G.pfma(A, B, C, ref_cfg))


# --------------------------------------------------------------------------
# posit16: seeded samples
# --------------------------------------------------------------------------
@pytest.mark.parametrize("es", [1, 2], ids=["P16_1", "P16_2"])
@pytest.mark.parametrize("op", ["padd", "psub", "pmul", "pfma", "plt"])
def test_p16_ops_sampled(es, op):
    from repro.core import golden as G
    pair = _cfgs(16, es)
    k = 3 if op == "pfma" else 2
    operands = _sample(16, 1 << 18, seed=20 + es, k=k)
    got, want = _both(op, pair, *operands)
    np.testing.assert_array_equal(got, want)
    if op != "plt":
        np.testing.assert_array_equal(got, getattr(G, op)(*operands, pair[0]))


@pytest.mark.parametrize("es", [1, 2], ids=["P16_1", "P16_2"])
@pytest.mark.parametrize("mode,nr", DIV_CASES)
def test_p16_divide_sampled(es, mode, nr):
    from repro.core import golden as G
    pair = _cfgs(16, es)
    A, B = _sample(16, 1 << 18, seed=30 + es)
    got, want = _both("pdiv", pair, A, B, mode=mode, nr_rounds=nr)
    np.testing.assert_array_equal(got, want)
    if mode in ("exact", "poly_corrected"):
        np.testing.assert_array_equal(got, G.pdiv(A, B, pair[0]))


@pytest.mark.parametrize("es", [1, 2], ids=["P16_1", "P16_2"])
def test_p16_edge_operands_against_every_pattern(es):
    """0, NaR, +-1, +-minpos, +-maxpos against all 65,536 patterns, on both
    sides of each op: the special-case masks and the saturation."""
    ref_cfg, cfg = pair = _cfgs(16, es)
    m = cfg.mask
    edge = np.array([0, cfg.nar, cfg.one_bits, -cfg.one_bits & m, 1, m,
                     cfg.maxpos_bits, -cfg.maxpos_bits & m])
    allp = np.arange(1 << 16)
    A = np.concatenate([np.repeat(edge, allp.size), np.tile(allp, edge.size)])
    B = np.concatenate([np.tile(allp, edge.size), np.repeat(edge, allp.size)])
    for op, kw in (("padd", {}), ("psub", {}), ("pmul", {}),
                   ("pdiv", {"mode": "poly_corrected"}),
                   ("pdiv", {"mode": "poly"}), ("pdiv", {"mode": "pacogen"})):
        got, want = _both(op, pair, A, B, **kw)
        np.testing.assert_array_equal(got, want, err_msg=f"{op} {kw}")
    C = np.roll(A, 12345)
    for trio in ((A, B, C), (C, A, B), (B, C, A)):
        got, want = _both("pfma", pair, *trio)
        np.testing.assert_array_equal(got, want, err_msg="pfma")


# --------------------------------------------------------------------------
# the reference's Pallas kernels in interpret mode, every posit8 pair
# --------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["add", "sub", "mul", "fma"])
def test_elementwise_plain_matches_pallas_interpret(op):
    import jax.numpy as jnp
    from repro.kernels import posit_elementwise as PE
    from repro_torch.kernels import ops
    from repro_torch.kernels import posit_elementwise as TE
    ref_cfg, cfg = _cfgs(8, 2)
    A, B = (x.astype(np.int8) for x in _p8_pairs())
    ins = [A, B] + ([np.roll(A, 77)] if op == "fma" else [])
    want = PE.elementwise(op, *(jnp.asarray(x) for x in ins), cfg=ref_cfg,
                          interpret=True)
    ops.reset_counters()
    got = TE.elementwise(op, *(torch.from_numpy(x) for x in ins), cfg=cfg)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops.plain_counts()["elementwise"] == 1
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.parametrize("mode", ["exact", "poly", "poly_corrected",
                                  "pacogen"])
def test_divide_plain_matches_pallas_interpret(mode):
    import jax.numpy as jnp
    from repro.kernels import posit_elementwise as PE
    from repro_torch.kernels import ops
    from repro_torch.kernels import posit_elementwise as TE
    ref_cfg, cfg = _cfgs(8, 2)
    A, B = (x.astype(np.int8) for x in _p8_pairs())
    want = PE.divide(jnp.asarray(A), jnp.asarray(B), cfg=ref_cfg, mode=mode,
                     interpret=True)
    ops.reset_counters()
    got = TE.divide(torch.from_numpy(A), torch.from_numpy(B), cfg=cfg,
                    mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops.plain_counts()["divide"] == 1
    assert sum(ops.launch_counts().values()) == 0


# --------------------------------------------------------------------------
# Table II: wrong-% of the approximate dividers, same pairs, same numbers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,es", [(8, 0), (16, 2)], ids=["P8_0", "P16_2"])
def test_table2_wrong_pct_equals_reference(n, es):
    """The sample of tests/test_posit_core.py:96 (every pair for p8,
    100,000 seeded pairs for p16): the port's wrong-% of poly (NR 1) and
    pacogen (the paper's NR: 0 for p8, 1 for p16) against the exact
    divider equals the reference's exactly."""
    from repro.core import golden as G
    pair = _cfgs(n, es)
    if n == 8:
        A, B = _p8_pairs()
    else:
        rng = np.random.default_rng(0)
        A, B = rng.integers(0, 1 << n, 100_000), rng.integers(0, 1 << n,
                                                              100_000)
    exact = G.pdiv(A, B, pair[0])
    for mode, nr in (("poly", 1), ("pacogen", 0 if n == 8 else 1)):
        got, want = _both("pdiv", pair, A, B, mode=mode, nr_rounds=nr)
        pct_port = 100.0 * float((got != exact).mean())
        pct_ref = 100.0 * float((want != exact).mean())
        assert pct_port == pct_ref, (mode, pct_port, pct_ref)
    assert pct_port > 0                    # the approximation is not exact


# --------------------------------------------------------------------------
# core/recip.py
# --------------------------------------------------------------------------
def test_pacogen_lut_equals_reference():
    from repro.core import recip as RR
    from repro_torch.core import recip as TR
    np.testing.assert_array_equal(TR._PACOGEN_LUT, RR._PACOGEN_LUT)
    assert TR._PACOGEN_LUT.dtype == np.int32


def test_recip_fixed_point_every_14bit_x():
    """recip_poly_fx on every x in [0.5, 1) at 14 fraction bits, and one
    Newton-Raphson round on it and on every PACoGen-style m_b in [1, 2)."""
    import jax.numpy as jnp
    from repro.core import recip as RR
    from repro_torch.core import recip as TR
    X = np.arange(1 << 13, 1 << 14, dtype=np.int32)
    y_ref = np.asarray(RR.recip_poly_fx(jnp.asarray(X)))
    y = TR.recip_poly_fx(torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_array_equal(
        TR.nr_round_fx(torch.from_numpy(y), torch.from_numpy(X)).numpy(),
        np.asarray(RR.nr_round_fx(jnp.asarray(y_ref), jnp.asarray(X))))
    X2 = np.arange(1 << 14, 1 << 15, dtype=np.int32)
    Y2 = (RR._PACOGEN_LUT[(X2 - (1 << 14)) >> 6].astype(np.int32)
          << (28 - RR.PACOGEN_LUT_OUT))
    np.testing.assert_array_equal(
        TR.nr_round_fx(torch.from_numpy(Y2), torch.from_numpy(X2)).numpy(),
        np.asarray(RR.nr_round_fx(jnp.asarray(Y2), jnp.asarray(X2))))
    for k1, k2 in ((RR.K1_OPT, RR.K2_OPT), (RR.K1_REF19, RR.K2_REF19)):
        np.testing.assert_array_equal(
            TR.recip_poly_fx(torch.from_numpy(X), k1, k2).numpy(),
            np.asarray(RR.recip_poly_fx(jnp.asarray(X), k1, k2)))


def test_recip_f32_helpers_and_constants():
    import jax.numpy as jnp
    from repro.core import recip as RR
    from repro_torch.core import recip as TR
    x = np.linspace(0.5, 1.0, 1001, dtype=np.float32)
    np.testing.assert_allclose(TR.recip_poly_f32(torch.from_numpy(x)).numpy(),
                               np.asarray(RR.recip_poly_f32(jnp.asarray(x))),
                               rtol=1e-6)
    y = 1.0 / x
    np.testing.assert_allclose(
        TR.nr_round(torch.from_numpy(y), torch.from_numpy(x)).numpy(),
        np.asarray(RR.nr_round(jnp.asarray(y), jnp.asarray(x))), rtol=1e-6)
    ref_cfg, cfg = _cfgs(16, 2)
    frac = np.arange(1 << 13, dtype=np.int32)
    np.testing.assert_array_equal(
        TR.recip_pacogen_f32(torch.from_numpy(frac), cfg).numpy(),
        np.asarray(RR.recip_pacogen_f32(jnp.asarray(frac), ref_cfg)))
    k1, k2, e2 = TR.optimize_k1_k2()
    r1, r2, re2 = RR.optimize_k1_k2()
    assert abs(k1 - r1) < 1e-9 and abs(k2 - r2) < 1e-9
    assert abs(e2 - re2) < 1e-12
    assert TR.squared_rel_err(TR.K1_REF19, TR.K2_REF19) == \
        RR.squared_rel_err(RR.K1_REF19, RR.K2_REF19)


# --------------------------------------------------------------------------
# quire and packing
# --------------------------------------------------------------------------
def test_quire_matmul_and_dot_against_reference():
    import jax.numpy as jnp
    from repro.core import quire as RQ
    from repro_torch.core import quire as TQ
    ref_cfg, cfg = _cfgs(16, 2)
    rng = np.random.default_rng(3)
    a = rng.integers(-(1 << 15) + 1, 1 << 15, (16, 96)).astype(np.int16)
    b = rng.integers(-(1 << 15) + 1, 1 << 15, (96, 12)).astype(np.int16)
    acc_ref = np.asarray(RQ.quire_matmul(jnp.asarray(a), jnp.asarray(b),
                                         ref_cfg, out_posit=False))
    acc = TQ.quire_matmul(torch.from_numpy(a), torch.from_numpy(b), cfg,
                          out_posit=False).numpy()
    # f32 sums of 96 exact products in two orders
    np.testing.assert_allclose(acc, acc_ref, rtol=1e-6,
                               atol=1e-6 * np.abs(acc_ref).max())
    bt = np.ascontiguousarray(b.T)                 # [12, 96]
    d_ref = np.asarray(RQ.quire_dot(jnp.asarray(a[:12]), jnp.asarray(bt),
                                    ref_cfg, out_posit=False))
    d = TQ.quire_dot(torch.from_numpy(a[:12]), torch.from_numpy(bt), cfg,
                     out_posit=False).numpy()
    np.testing.assert_allclose(d, d_ref, rtol=1e-6,
                               atol=1e-6 * np.abs(d_ref).max())


def test_packing_against_reference():
    import jax.numpy as jnp
    from repro.core import ops as RO
    from repro.core import packing as RP
    from repro_torch.core import ops as TO
    from repro_torch.core import packing as TP
    rng = np.random.default_rng(4)
    for n, es in ((8, 2), (16, 2)):
        ref_cfg, cfg = _cfgs(n, es)
        dt = np.int8 if n == 8 else np.int16
        x = rng.integers(-(1 << (n - 1)), 1 << (n - 1), (8, 32)).astype(dt)
        y = rng.integers(-(1 << (n - 1)), 1 << (n - 1), (8, 32)).astype(dt)
        assert TP.lanes(cfg) == RP.lanes(ref_cfg)
        w_ref = np.asarray(RP.pack_words(jnp.asarray(x), ref_cfg))
        w = TP.pack_words(torch.from_numpy(x), cfg)
        assert w.dtype == torch.int32
        np.testing.assert_array_equal(w.numpy(), w_ref)
        back = TP.unpack_words(w, cfg)
        assert back.dtype == torch.from_numpy(x).dtype
        np.testing.assert_array_equal(back.numpy(), x)
        pm = TP.packed_map(TO.padd, TP.pack_words(torch.from_numpy(x), cfg),
                           TP.pack_words(torch.from_numpy(y), cfg), cfg)
        pm_ref = RP.packed_map(RO.padd, RP.pack_words(jnp.asarray(x),
                                                      ref_cfg),
                               RP.pack_words(jnp.asarray(y), ref_cfg),
                               ref_cfg)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(pm_ref))


def test_bf16_helpers_against_reference():
    import jax.numpy as jnp
    from repro.core import convert as RC
    from repro_torch.core import convert as TC
    ref_cfg, cfg = _cfgs(16, 2)
    pats = np.arange(-(1 << 15), 1 << 15).astype(np.int16)
    want = np.asarray(RC.posit_to_bf16(jnp.asarray(pats), ref_cfg)
                      .astype(jnp.float32))
    got = TC.posit_to_bf16(torch.from_numpy(pats), cfg).float().numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    v = np.random.default_rng(5).standard_normal(4096).astype(np.float32)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    want = np.asarray(RC.bf16_to_posit(jnp.asarray(vb.float().numpy())
                                       .astype(jnp.bfloat16), ref_cfg))
    np.testing.assert_array_equal(TC.bf16_to_posit(vb, cfg).numpy(), want)
