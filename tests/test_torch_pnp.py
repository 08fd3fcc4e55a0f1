"""repro_torch.pnp and the PositArray operators against repro.pnp: the
same cases as tests/test_posit_array.py, run on the CPU (plain versions),
with inputs made by numpy and handed to both packages."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

CPU = "cpu"


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)


def _pnp():
    import repro.pnp as rpnp
    import repro_torch.pnp as tpnp
    return rpnp, tpnp


def _cfg(name):
    rpnp, tpnp = _pnp()
    return getattr(rpnp, name), getattr(tpnp, name)


def _bits(x) -> np.ndarray:
    b = x.bits
    return b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)


def test_namespace_offers_every_reference_name():
    rpnp, tpnp = _pnp()
    missing = [n for n in rpnp.__all__ if not hasattr(tpnp, n)]
    assert not missing, missing
    assert sorted(tpnp.__all__) == sorted(rpnp.__all__)


def test_operators_bit_identical_exhaustive_p8():
    """Every p8 pair through the operators equals the functional ops of
    both packages (the reference's repro.core intrinsics)."""
    import jax.numpy as jnp
    from repro import core as R
    rpnp, tpnp = _pnp()
    ref_cfg, cfg = _cfg("P8_2")
    bits = np.arange(256)
    A, B = np.meshgrid(bits, bits)
    ab, bb = A.ravel().astype(np.int8), B.ravel().astype(np.int8)
    a = tpnp.frombits(torch.from_numpy(ab), cfg)
    b = tpnp.frombits(torch.from_numpy(bb), cfg)
    ja, jb = jnp.asarray(ab), jnp.asarray(bb)
    cases = [(a + b, R.padd(ja, jb, ref_cfg)),
             (a - b, R.psub(ja, jb, ref_cfg)),
             (a * b, R.pmul(ja, jb, ref_cfg)),
             (a / b, R.pdiv(ja, jb, ref_cfg)),
             (-a, R.pneg(ja, ref_cfg)),
             (abs(a), R.pabs(ja, ref_cfg)),
             (tpnp.fma(a, b, a), R.pfma(ja, jb, ja, ref_cfg)),
             (tpnp.reciprocal(a), R.precip(ja, ref_cfg))]
    for got, want in cases:
        assert got.cfg == cfg and got.dtype == torch.int8
        np.testing.assert_array_equal(_bits(got), np.asarray(want))
    for mode in ("exact", "poly", "pacogen"):
        np.testing.assert_array_equal(
            _bits(tpnp.divide(a, b, mode=mode, nr_rounds=0)),
            np.asarray(R.pdiv(ja, jb, ref_cfg, mode=mode, nr_rounds=0)))


def test_operators_match_repro_pnp_p16(rng):
    rpnp, tpnp = _pnp()
    ref_cfg, cfg = _cfg("P16_2")
    x = rng.normal(size=(8, 64)).astype(np.float32)
    y = rng.normal(size=(64,)).astype(np.float32)
    ra, rb = rpnp.asarray(x, ref_cfg), rpnp.asarray(y, ref_cfg)
    ta = tpnp.asarray(x, cfg, device=CPU)
    tb = tpnp.asarray(y, cfg, device=CPU)
    np.testing.assert_array_equal(_bits(ta), _bits(ra))
    for got, want in ((ta + tb, ra + rb), (ta - tb, ra - rb),
                      (ta * tb, ra * rb), (ta / tb, ra / rb),
                      (2.0 * ta, 2.0 * ra), (1 - ta, 1 - ra),
                      (ta / 3, ra / 3), (3 / ta, 3 / ra),
                      (tpnp.sign(ta), rpnp.sign(ra)),
                      (ta.astype(tpnp.P8_2), ra.astype(rpnp.P8_2))):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(ta.to_f32().numpy(), np.asarray(ra.to_f32()))
    np.testing.assert_array_equal(
        ta.to_bf16().float().numpy(),
        np.asarray(ra.to_bf16().astype(np.float32)))


def _adjacent(got: np.ndarray, want: np.ndarray, n: int) -> int:
    """Assert got == want except for patterns one step apart on the posit
    ring (a rounding boundary between two f32 accumulators); return how
    many differ."""
    d = (got.astype(np.int64) - want.astype(np.int64)) % (1 << n)
    assert np.isin(d, [0, 1, (1 << n) - 1]).all()
    return int((d != 0).sum())


def test_matmul_and_dot_against_repro_pnp(rng):
    """@ and pnp.dot: f32 accumulators within 1e-6 relative of repro's (f32
    sums of exact products in another order); posit outputs equal, or one
    pattern apart where the two accumulators straddle a rounding boundary:
    at most 1% of the outputs."""
    rpnp, tpnp = _pnp()
    adjacent, total = 0, 0
    for name in ("P8_2", "P16_2"):
        ref_cfg, cfg = _cfg(name)
        x = rng.normal(size=(24, 96)).astype(np.float32)
        w = (rng.normal(size=(96, 40)) / 10).astype(np.float32)
        ra, rb = rpnp.asarray(x, ref_cfg), rpnp.asarray(w, ref_cfg)
        ta, tb = tpnp.asarray(x, cfg, device=CPU), tpnp.asarray(w, cfg,
                                                                device=CPU)
        acc_ref = np.asarray(rpnp.matmul(ra, rb, out_posit=False))
        acc = tpnp.matmul(ta, tb, out_posit=False).numpy()
        np.testing.assert_allclose(acc, acc_ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(acc_ref).max())
        got = ta @ tb
        assert got.cfg == cfg and tuple(got.shape) == (24, 40)
        adjacent += _adjacent(_bits(got), _bits(ra @ rb), cfg.n)
        total += got.size
        d_ref = rpnp.dot(ra[:8], rb.T[:8])
        d = tpnp.dot(ta[:8], tb.T[:8])
        adjacent += _adjacent(_bits(d), _bits(d_ref), cfg.n)
        total += d.size
        np.testing.assert_allclose(
            tpnp.dot(ta[:8], tb.T[:8], out_posit=False).numpy(),
            np.asarray(rpnp.dot(ra[:8], rb.T[:8], out_posit=False)),
            rtol=1e-6, atol=1e-6)
    assert adjacent <= total // 100, (adjacent, total)


def test_comparisons_and_scalar_mixing(rng):
    rpnp, tpnp = _pnp()
    ref_cfg, cfg = _cfg("P16_2")
    x = rng.normal(size=(64,)).astype(np.float32)
    y = rng.normal(size=(64,)).astype(np.float32)
    a, b = tpnp.asarray(x, cfg, device=CPU), tpnp.asarray(y, cfg, device=CPU)
    ra, rb = rpnp.asarray(x, ref_cfg), rpnp.asarray(y, ref_cfg)
    for fn in ("equal", "not_equal", "less", "less_equal", "greater",
               "greater_equal"):
        np.testing.assert_array_equal(getattr(tpnp, fn)(a, b).numpy(),
                                      np.asarray(getattr(rpnp, fn)(ra, rb)))
    lt = (a < b).numpy()
    assert ((a >= b).numpy() == ~lt).all()
    assert (tpnp.equal(a, a).numpy()).all()
    assert ((a < 0.0).numpy() == (x < 0)).all()
    # scalars are values, correctly rounded into a's format
    from repro_torch.core.ops import pmul
    want = pmul(tpnp.asarray(2.0, cfg, device=CPU).bits, a.bits, cfg)
    np.testing.assert_array_equal((2.0 * a).bits.numpy(), want.numpy())
    one = tpnp.ones_like(a)
    np.testing.assert_array_equal((1 - a).bits.numpy(), (one - a).bits.numpy())


def test_config_mismatch_raises():
    _, tpnp = _pnp()
    a = tpnp.asarray(1.5, tpnp.P16_2, device=CPU)
    b = tpnp.asarray(1.5, tpnp.P8_2, device=CPU)
    for fn in (lambda: a + b, lambda: a * b, lambda: a / b, lambda: a < b,
               lambda: a @ b, lambda: tpnp.fma(a, b, a),
               lambda: tpnp.where(True, a, b), lambda: tpnp.matmul(a, b)):
        with pytest.raises(tpnp.PositConfigMismatchError):
            fn()
    with pytest.raises(tpnp.PositConfigMismatchError):
        tpnp.asarray(a, tpnp.P8_2)
    # the explicit cast works and is exact (widening)
    assert float(b.astype(tpnp.P16_2).to_f32()) == float(b.to_f32())


def test_int_arrays_rejected_as_ambiguous():
    _, tpnp = _pnp()
    a = tpnp.asarray(1.5, tpnp.P16_2, device=CPU)
    with pytest.raises(TypeError):
        a + np.arange(3)
    with pytest.raises(TypeError):
        a + torch.arange(3)
    with pytest.raises(TypeError):
        tpnp.asarray(np.arange(3), tpnp.P16_2, device=CPU)
    with pytest.raises(TypeError):
        tpnp.asarray(torch.arange(3), tpnp.P16_2)
    # payload ints go through the explicit constructor
    assert tpnp.frombits(np.arange(3, dtype=np.int16), tpnp.P16_2,
                         device=CPU).shape == (3,)
    # ...which refuses float "bits" and out-of-range payloads
    with pytest.raises(TypeError):
        tpnp.frombits(np.array([1.5, 2.0], np.float32), tpnp.P16_2,
                      device=CPU)
    with pytest.raises(ValueError):
        tpnp.frombits(np.arange(300), tpnp.P8_2, device=CPU)


def test_scalar_broadcast_through_dispatch(rng):
    """Scalar and broadcast operands are expanded at the dispatch layer
    (the kernels take same-shaped operands)."""
    from repro_torch.kernels import ops as kops
    _, tpnp = _pnp()
    cfg = tpnp.P16_2
    a = tpnp.asarray(rng.normal(size=(8, 64)).astype(np.float32), cfg,
                     device=CPU)
    two = tpnp.asarray(2.0, cfg, device=CPU)
    out = kops.elementwise("mul", a, two)
    assert tuple(out.shape) == (8, 64)
    np.testing.assert_array_equal(out.bits.numpy(), (a * 2.0).bits.numpy())
    rev = two - a
    assert tuple(rev.shape) == (8, 64)
    row = tpnp.asarray(rng.normal(size=(64,)).astype(np.float32), cfg,
                       device=CPU)
    got = kops.divide(a, row)
    assert tuple(got.shape) == (8, 64)
    np.testing.assert_array_equal(got.bits[3].numpy(),
                                  (a[3] / row).bits.numpy())
    with pytest.raises(TypeError):
        kops.gemm(a.bits[:4, :4], a.bits[:4, :4])


def test_ste_gradient_is_identity(rng):
    _, tpnp = _pnp()
    w = torch.tensor(rng.normal(size=(4, 4)), dtype=torch.float32,
                     requires_grad=True)
    y = tpnp.ste(w, tpnp.P16_2)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), 2 * y.detach().numpy(),
                               rtol=1e-6)
    g = torch.randn(4, 4)
    w.grad = None
    tpnp.ste(w, tpnp.P8_2).backward(g)
    assert torch.equal(w.grad, g)


def test_ste_forward_matches_reference(rng):
    import jax.numpy as jnp
    rpnp, tpnp = _pnp()
    x = rng.normal(size=(64,)).astype(np.float32)
    for name in ("P8_2", "P16_2"):
        ref_cfg, cfg = _cfg(name)
        np.testing.assert_array_equal(
            tpnp.ste(torch.from_numpy(x), cfg).numpy(),
            np.asarray(rpnp.ste(jnp.asarray(x), ref_cfg)))


def test_constructors_and_where_sign(rng):
    _, tpnp = _pnp()
    cfg = tpnp.P8_2
    z = tpnp.zeros((3, 4), cfg, device=CPU)
    assert (z.bits.numpy() == 0).all() and z.dtype == torch.int8
    o = tpnp.ones((3, 4), cfg, device=CPU)
    assert (o.to_f32().numpy() == 1.0).all()
    f = tpnp.full((5,), -2.5, cfg, device=CPU)
    assert np.allclose(f.to_f32().numpy(), -2.5)
    assert tpnp.full_like(f, 0.5).to_f32().tolist() == [0.5] * 5
    assert tpnp.zeros_like(f).device.type == CPU

    a = tpnp.asarray(rng.normal(size=(32,)).astype(np.float32), cfg,
                     device=CPU)
    w = tpnp.where(a < 0.0, tpnp.zeros_like(a), a)
    assert (w.to_f32().numpy() >= 0).all()
    s = tpnp.sign(a)
    np.testing.assert_array_equal(s.to_f32().numpy(),
                                  np.sign(a.to_f32().numpy()))
    np.testing.assert_array_equal(tpnp.to_float32(a).numpy(),
                                  a.to_f32().numpy())
    assert tpnp.to_bfloat16(a).dtype == torch.bfloat16
    assert tpnp.astype(a, tpnp.P16_2).cfg == tpnp.P16_2
    assert bool((tpnp.negative(tpnp.negative(a)) == a).all())
    assert tpnp.abs is tpnp.absolute


def test_entry_points_default_to_the_card():
    """Plain values and new arrays go to 'cuda' unless the caller names the
    CPU; a tensor keeps its own device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tpnp = _pnp()
    for fn in (lambda: tpnp.asarray([1.0, 2.0], tpnp.P16_2),
               lambda: tpnp.zeros((2,), tpnp.P16_2),
               lambda: tpnp.ones((2,), tpnp.P16_2),
               lambda: tpnp.full((2,), 1.0, tpnp.P16_2),
               lambda: tpnp.frombits(np.zeros(2, np.int16), tpnp.P16_2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    a = tpnp.asarray(torch.ones(3), tpnp.P16_2)
    assert a.device.type == CPU


def test_pack_unpack_roundtrip(rng):
    import jax.numpy as jnp
    rpnp, tpnp = _pnp()
    for name, dt in (("P8_2", np.int8), ("P16_2", np.int16)):
        ref_cfg, cfg = _cfg(name)
        x = rng.integers(-(1 << (cfg.n - 1)), 1 << (cfg.n - 1),
                         (4, 32)).astype(dt)
        a = tpnp.frombits(x, cfg, device=CPU)
        w = tpnp.pack(a)
        assert w.dtype == torch.int32
        assert w.shape[-1] == 32 // tpnp.lanes(cfg) == 32 // tpnp.lanes(a)
        np.testing.assert_array_equal(
            w.numpy(), np.asarray(rpnp.pack(rpnp.frombits(jnp.asarray(x),
                                                           ref_cfg))))
        back = tpnp.unpack(w, cfg)
        np.testing.assert_array_equal(back.bits.numpy(), x)


def test_shims_match_new_api(rng):
    """Raw bits + explicit cfg (the older calling convention) give the same
    bits as PositArray operands."""
    from repro_torch.kernels import ops as kops
    _, tpnp = _pnp()
    cfg = tpnp.P16_2
    xb = torch.from_numpy(rng.integers(-(1 << 15) + 1, 1 << 15,
                                       (6, 8)).astype(np.int16))
    yb = torch.from_numpy(rng.integers(-(1 << 15) + 1, 1 << 15,
                                       (6, 8)).astype(np.int16))
    x, y = tpnp.frombits(xb, cfg), tpnp.frombits(yb, cfg)
    old = kops.elementwise("add", xb, yb, cfg=cfg)
    new = kops.elementwise("add", x, y)
    assert isinstance(new, tpnp.PositArray)
    assert torch.equal(old, new.bits)
    assert torch.equal(kops.divide(xb, yb, cfg=cfg), kops.divide(x, y).bits)
    mb = torch.from_numpy(rng.integers(-(1 << 15) + 1, 1 << 15,
                                       (8, 5)).astype(np.int16))
    m = tpnp.frombits(mb, cfg)
    old = kops.gemm(xb, mb, cfg_a=cfg, cfg_b=cfg, cfg_out=cfg, out_posit=True)
    new = kops.gemm(x, m, out_posit=True)
    assert isinstance(new, tpnp.PositArray)
    assert torch.equal(old, new.bits)
    with pytest.raises(ValueError):
        kops.elementwise("add", x, y, cfg=tpnp.P8_2)


def test_numpy_and_torch_left_operands_and_foreign_eq(rng):
    _, tpnp = _pnp()
    cfg = tpnp.P16_2
    a = tpnp.asarray(rng.normal(size=(4,)).astype(np.float32), cfg,
                     device=CPU)
    f = np.ones((4,), np.float32)
    out = f + a
    assert isinstance(out, tpnp.PositArray)
    want = tpnp.asarray(f, cfg, device=CPU) + a
    assert torch.equal(out.bits, want.bits)
    assert isinstance(f * a, tpnp.PositArray)
    out = torch.ones(4) + a
    assert isinstance(out, tpnp.PositArray)
    assert torch.equal(out.bits, want.bits)
    assert (a == None) is False          # noqa: E711
    assert (a != "x") is True
    with pytest.raises(TypeError):
        a == a.bits                      # noqa: B015
    with pytest.raises(tpnp.PositConfigMismatchError):
        a == tpnp.asarray(1.0, tpnp.P8_2, device=CPU)  # noqa: B015


def test_float_payload_and_mixed_gemm_guards(rng):
    from repro_torch.kernels import ops as kops
    _, tpnp = _pnp()
    cfg = tpnp.P16_2
    a = tpnp.asarray(rng.normal(size=(4,)).astype(np.float32), cfg,
                     device=CPU)
    f = torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))
    with pytest.raises(TypeError):
        kops.elementwise("add", a, f)
    with pytest.raises(TypeError):
        kops.divide(a, f)
    e8 = tpnp.asarray(np.eye(4, dtype=np.float32), tpnp.P8_2, device=CPU)
    e16 = tpnp.asarray(np.eye(4, dtype=np.float32), cfg, device=CPU)
    with pytest.raises(tpnp.PositConfigMismatchError):
        kops.gemm(e8, e16, out_posit=True)
    out = kops.gemm(e8, e16, cfg_out=cfg, out_posit=True)
    assert isinstance(out, tpnp.PositArray) and out.cfg == cfg
    np.testing.assert_array_equal(out.to_f32().numpy(), np.eye(4))
    got = kops.elementwise("add", a, a.bits)
    assert torch.equal(got.bits, (a + a).bits)
    with pytest.raises(TypeError):
        kops.elementwise("add", a, 1.5)
    with pytest.raises(TypeError):
        kops.elementwise("add", a, 7)
    w16 = tpnp.asarray(rng.normal(size=(4, 3)).astype(np.float32), cfg,
                       device=CPU)
    with pytest.raises(TypeError):
        kops.gemm(a.reshape(1, 4).bits, w16)
    acts = torch.from_numpy(rng.normal(size=(2, 4)).astype(np.float32))
    assert tuple(kops.gemm(acts, w16).shape) == (2, 3)


def test_float_activation_gemm_takes_the_pw_form(rng):
    """f32 activations @ posit weights run the pw form (and, for posit out,
    one encode of its f32 result), matching repro's gemm on the same
    inputs: the f32 sums within 1e-6 relative, posit out equal or one
    pattern apart."""
    import jax.numpy as jnp
    from repro.kernels import ops as rops
    from repro_torch.kernels import ops as kops
    rpnp, tpnp = _pnp()
    x = rng.normal(size=(3, 16)).astype(np.float32)
    w = rng.normal(size=(16, 5)).astype(np.float32)
    r_w = rpnp.asarray(w, rpnp.P16_2)
    t_w = tpnp.asarray(w, tpnp.P16_2, device=CPU)
    kops.reset_counters()
    acc = kops.gemm(torch.from_numpy(x), t_w)
    pos = kops.gemm(torch.from_numpy(x), t_w, out_posit=True)
    plain = kops.plain_counts()
    assert plain["pw_gemm"] == 2 and plain["posit_gemm"] == 0
    assert plain["encode_block"] == 1
    want = np.asarray(rops.gemm(jnp.asarray(x), r_w))
    np.testing.assert_allclose(acc.numpy(), want, rtol=1e-6, atol=1e-6)
    want_pos = rops.gemm(jnp.asarray(x), r_w, out_posit=True)
    assert isinstance(pos, tpnp.PositArray) and pos.cfg == tpnp.P16_2
    d = np.abs(pos.bits.numpy().astype(np.int32)
               - _bits(want_pos).astype(np.int32))
    assert d.max() <= 1


def test_positarray_views(rng):
    _, tpnp = _pnp()
    a = tpnp.frombits(rng.integers(-100, 100, (2, 3, 4)).astype(np.int8),
                      tpnp.P8_2, device=CPU)
    assert a.ndim == 3 and a.size == 24 and a.nbytes == 24 and len(a) == 2
    assert tuple(a.T.shape) == (4, 3, 2)
    assert tuple(a.transpose(1, 0, 2).shape) == (3, 2, 4)
    assert tuple(a.reshape(6, 4).shape) == (6, 4)
    assert tuple(a.ravel().shape) == (24,) == tuple(a.flatten().shape)
    assert tuple(a[:, :1].squeeze(1).shape) == (2, 4)
    assert tuple(a[:1, :1].squeeze().shape) == (4,)
    assert torch.equal(a.T.T.bits, a.bits)
    assert "posit8es2" in repr(a)
    with pytest.raises(TypeError):
        hash(a)
    with pytest.raises(TypeError):
        a.astype(torch.float32)


def test_arithmetic_wrappers_count_plain_calls_on_cpu(rng):
    """CPU arrays run the plain versions (counted), never a launch."""
    from repro_torch.kernels import ops
    _, tpnp = _pnp()
    cfg = tpnp.P16_2
    a = tpnp.asarray(rng.normal(size=(4, 4)).astype(np.float32), cfg,
                     device=CPU)
    ops.reset_counters()
    _ = a + a, a * a, tpnp.fma(a, a, a), a / a, a @ a
    plain = ops.plain_counts()
    assert plain["elementwise"] == 3 and plain["divide"] == 1
    assert plain["posit_gemm"] == 1
    assert sum(ops.launch_counts().values()) == 0
