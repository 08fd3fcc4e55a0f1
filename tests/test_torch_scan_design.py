"""K12's and K13's arithmetic on the CPU: the direct posit round trip and
K12's summation order, against `repro`.

The kernels (``csrc/recurrent_scan.cu``) run only on a GPU; these tests
hold what they compute:

- `rt_mirror`, a numpy mirror of the kernels' `posit_rt` (one f32 add and
  subtract of 2^(te+sh) where the posit keeps a fraction bit, the codec
  elsewhere), bit for bit against `repro`'s decode_to_f32(f32_to_posit())
  for P16_2, P8_2 and five other formats (es 0 to 3): every pattern's
  value, every midpoint between neighbours and its two f32 neighbours,
  every f32 exponent with seeded mantissas, +-0, +-subnormals, +-Inf,
  NaN, and values past maxpos and minpos;
- a plain model of K12's order (chunks of WKV_TC staged tokens, a ragged
  last one; su once per token by a warp's butterfly; y as WKV_R partial
  dot products combined by the kernel's xor shuffles; the last live
  token of a posit state encoded straight from its update) against
  `repro`'s `wkv_scan_ref`: the state bit-identical in the four state
  modes, y within chip_smoke.py's `_wkv_y_bound`; and K13's chain on the
  same round trip against `rglru_scan_ref`, bit-identical;
- the Python mirror of the plan constants against the source.

Against `repro` the models take e^w from the same jnp.exp (the kernel's
expf is matched on the card by chip_smoke.py, not here).  XLA's CPU
backend contracts K12's update into fma(k, v, e S) or fma(e, S, k v), as
its fusion goes, and K13's into fma(a, h, b); so there k, v, e^w and a
carry 12 significant bits, the products with a posit16 state are exact in
f32, and an FMA rounds as the kernels' separate product and sum do.
Against the port's plain versions (which, like the kernels, never
contract) the inputs are full f32.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORMATS = [(16, 2), (8, 2), (16, 1), (8, 0), (12, 3), (16, 3), (6, 1)]
# state modes: (name, (n, es) of the state's format or None, posit_state)
STATE_MODES = [("p16", (16, 2), True), ("p8", (8, 2), True),
               ("f32-rt", (16, 2), False), ("f32", None, False)]
U32 = np.uint32


def _ref_cfg(fmt):
    from repro.core.types import PositConfig
    return None if fmt is None else PositConfig(*fmt)


def _port_cfg(fmt):
    from repro_torch.core.types import PositConfig
    return None if fmt is None else PositConfig(*fmt)


def _codec_rt(x, fmt):
    """repro's decode_to_f32(f32_to_posit(x)) as f32 numpy."""
    import jax.numpy as jnp
    from repro.core.convert import f32_to_posit
    from repro.core.decode import decode_to_f32
    cfg = _ref_cfg(fmt)
    return np.asarray(decode_to_f32(f32_to_posit(jnp.asarray(x), cfg), cfg))


def _port_encode(x, fmt):
    from repro_torch.kernels import ref
    return ref.encode_ref(torch.from_numpy(np.ascontiguousarray(x)),
                          _port_cfg(fmt)).numpy()


def _port_decode(bits, fmt):
    from repro_torch.kernels import ref
    return ref.decode_ref(torch.from_numpy(np.ascontiguousarray(bits)),
                          _port_cfg(fmt)).numpy()


# ---- the direct round trip ------------------------------------------------
def rt_fast_lanes(x, n, es):
    """Which lanes `posit_rt` takes by its fast path, and (where it does)
    the shift sh = 23 - fraction bits."""
    bits = x.view(U32).astype(np.int64)
    ex = (bits >> 23) & 0xFF
    span = (n - 3 - es) * (1 << es)
    lo, hi = max(127 - span, 1), min(126 + span, 232)
    fast = (ex >= lo) & (ex <= hi) & (hi >= lo)
    k = (ex - 127) >> es
    sh = 26 - n + es + np.where(k >= 0, k, -k - 1)
    return fast, sh


def rt_mirror(x, n, es):
    """numpy mirror of `posit_rt` in csrc/posit_codec.cuh: x + M - M in
    f32 with M = sign(x) 2^(te + sh) on the fast lanes, the port's codec
    (posit_decode(posit_encode(x))) on the others."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    fast, sh = rt_fast_lanes(x, n, es)
    bits = x.view(U32).astype(np.int64)
    m = ((bits & 0xFF800000) + (np.where(fast, sh, 0) << 23)) & 0xFFFFFFFF
    M = m.astype(U32).view(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        quick = (x + M) - M
    out = quick.copy()
    slow = ~fast
    if slow.any():
        xs = x[slow]
        out[slow] = _port_decode(_port_encode(xs, (n, es)), (n, es))
    return out


def _round_trip_inputs(n, es, seed=0):
    """Every pattern's value, the midpoints of neighbours and their f32
    neighbours, every f32 exponent with seeded mantissas (both signs), the
    specials, and values past maxpos and minpos."""
    from repro.core.decode import decode_to_f32
    import jax.numpy as jnp
    cfg = _ref_cfg((n, es))
    pats = np.arange(-(1 << (n - 1)), 1 << (n - 1), dtype=np.int32)
    vals = np.asarray(decode_to_f32(jnp.asarray(pats), cfg))
    vals = np.sort(vals[np.isfinite(vals)]).astype(np.float64)
    mids = ((vals[1:] + vals[:-1]) / 2).astype(np.float32)
    up = np.nextafter(mids, np.float32(np.inf))
    down = np.nextafter(mids, np.float32(-np.inf))
    rng = np.random.default_rng(seed)
    ex = np.repeat(np.arange(256, dtype=np.int64), 64)
    mant = rng.integers(0, 1 << 23, ex.size)
    sweep = ((ex << 23) | mant).astype(U32).view(np.float32)
    sweep = np.concatenate([sweep, -sweep])
    maxpos, minpos = vals.max(), vals[vals > 0].min()
    beyond = np.array([maxpos * 1.5, maxpos * 4, minpos / 1.5, minpos / 4,
                       minpos * 0.75, 3.0e38, 1e-30], np.float64)
    beyond = np.concatenate([beyond, -beyond]).astype(np.float32)
    sub = np.array([1, 2, 0x400000, 0x7FFFFF], np.int64).astype(U32).view(
        np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)
    return np.concatenate([vals.astype(np.float32), mids, up, down, sweep,
                           beyond, sub, -sub, specials]).astype(np.float32)


@pytest.mark.parametrize("fmt", FORMATS, ids=[f"p{n}e{es}" for n, es in
                                               FORMATS])
def test_round_trip_mirror_matches_the_codec(fmt):
    n, es = fmt
    x = _round_trip_inputs(n, es)
    got = rt_mirror(x, n, es)
    want = _codec_rt(x, fmt)
    bad = np.flatnonzero(got.view(U32) != want.view(U32))
    assert bad.size == 0, (
        f"{fmt}: {bad.size} of {x.size} differ, first x = "
        f"{x[bad[0]]!r} ({x.view(U32)[bad[0]]:#010x}): "
        f"{got[bad[0]]!r} against {want[bad[0]]!r}")
    fast, _ = rt_fast_lanes(x, n, es)
    assert fast.any() and not fast.all()          # both paths exercised


def test_round_trip_fast_range_is_case_a():
    """The fast lanes are exactly the binades where the pattern keeps every
    exponent bit and a fraction bit: P16_2 te in [-44, 43], P8_2
    [-12, 11]; sh leaves 11 fraction bits at 1.0 in P16_2."""
    for (n, es), (lo, hi) in {(16, 2): (-44, 43), (8, 2): (-12, 11)}.items():
        te = np.arange(-126, 128)
        x = np.ldexp(np.float32(1.5), te).astype(np.float32)
        fast, sh = rt_fast_lanes(x, n, es)
        assert te[fast].min() == lo and te[fast].max() == hi
    _, sh = rt_fast_lanes(np.array([1.0], np.float32), 16, 2)
    assert sh[0] == 12


# ---- K12's order ----------------------------------------------------------
def _fma(a, b, c):
    """f32 fma through float64 (the product is exact there)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _su_butterfly(r, u, k):
    """su of one token, [..., 64] -> [...]: lane l holds r u k at l and
    l + 32 (the second by an fma), then xor-butterfly sums 16, 8, 4, 2, 1;
    every lane ends with lane 0's value."""
    p = (r[..., :32] * u[..., :32]) * k[..., :32]
    p = _fma(r[..., 32:] * u[..., 32:], k[..., 32:], p)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        p = p + p[..., lanes ^ o]
    return p[..., 0]


def wkv_model(r, k, v, e, u, s0, nn, fmt, posit_state, TC, R):
    """K12 as the kernel orders it, one (b, h) at a time: r/k/v/e [B, H,
    T, 64] f32 (e = e^w), u [H, 64], s0 [B, H, 64, 64] (posit bits when
    posit_state) -> (y, the final state as s0 stores it)."""
    B, H, T, dh = r.shape
    rows = dh // R
    y = np.zeros_like(r)
    s_out = np.empty_like(s0)
    for b in range(B):
        live = min(max(int(nn[b]), 0), T)
        if live == 0:                       # idle: the bits copied
            s_out[b] = s0[b]
            continue
        S = (_port_decode(s0[b], fmt) if posit_state
             else s0[b].astype(np.float32))            # [H, dh, dh]
        for t0 in range(0, live, TC):
            ntok = min(TC, live - t0)
            st = slice(t0, t0 + ntok)                  # the staged chunk
            rs, ks, vs, es_ = r[b, :, st], k[b, :, st], v[b, :, st], \
                e[b, :, st]
            su = _su_butterfly(rs, u[:, None, :], ks)  # [H, ntok]
            for tt in range(ntok):
                t = t0 + tt
                rt_, kt, vt, et = rs[:, tt], ks[:, tt], vs[:, tt], \
                    es_[:, tt]
                part = []
                for q in range(R):                     # rows q*16 ..
                    acc = np.zeros((H, dh), np.float32)
                    for i in range(q * rows, (q + 1) * rows):
                        acc = _fma(rt_[:, i, None], S[:, i, :], acc)
                    part.append(acc)
                # lane q: (p_q + p_{q^1}) + (p_{q^2} + p_{q^3}), q = 0
                acc = (part[0] + part[1]) + (part[2] + part[3])
                y[b, :, t] = _fma(su[:, tt, None], vt, acc)
                x = et[:, :, None] * S + kt[:, :, None] * vt[:, None, :]
                if posit_state and t == live - 1:
                    S = _port_encode(x, fmt)           # pattern, no decode
                elif fmt is not None:
                    S = rt_mirror(x, *fmt)
                else:
                    S = x
        s_out[b] = S
    return y, s_out


def _wkv_y_bound(r, k, v, e, u, s0f, nn, fmt):
    """chip_smoke.py's `_wkv_y_bound`: each y is an f32 sum of dh + 1
    rounded terms taken in another order; both lie within gamma(dh + 4)
    of the exact sum of the terms' magnitudes, so twice that apart."""
    dh = r.shape[-1]
    m = dh + 4
    g = 2 * m * 2.0 ** -24 / (1 - m * 2.0 ** -24)
    S = s0f.astype(np.float64)
    out = []
    for t in range(r.shape[2]):
        rt_, kt, vt, et = (a[:, :, t].astype(np.float64) for a in
                           (r, k, v, e))
        mag = (np.einsum("bhd,bhdv->bhv", np.abs(rt_), np.abs(S))
               + np.abs(rt_ * u * kt).sum(-1, keepdims=True) * np.abs(vt))
        out.append(g * mag)
        S_new = et[..., None] * S + kt[..., None] * vt[:, :, None, :]
        if fmt is not None:
            S_new = _codec_rt(S_new.astype(np.float32), fmt)
        S = np.where((t < nn)[:, None, None, None], S_new, S)
    return np.stack(out, axis=2)


def _wkv_inputs(rng, B, H, T, dh=64):
    r, k, v = (rng.standard_normal((B, H, T, dh)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, H, T, dh)).astype(np.float32)
                   * 0.5 - 1.0)
    u = rng.standard_normal((H, dh)).astype(np.float32)
    s = (rng.standard_normal((B, H, dh, dh)) * 0.5).astype(np.float32)
    return r, k, v, logw.astype(np.float32), u, s


def _bits12(x):
    """x rounded to 12 significant bits (a product of two is exact)."""
    m, e = np.frexp(x.astype(np.float64))
    return np.ldexp(np.round(m * 4096.0) / 4096.0, e).astype(np.float32)


def _exact_decays(logw):
    """logw, clipped to (-1, 0) and moved by at most 64 f32 ulps, so that
    jnp.exp(logw) has 12 significant bits: e S is then exact for a
    posit16 S.  (Below -1 an f32 step of logw moves e by more than an ulp,
    and not every 12-bit decay has a logw.)"""
    import jax.numpy as jnp
    logw = np.clip(logw, -0.99, -0.01)
    target = _bits12(np.exp(logw.astype(np.float64)))
    base = np.log(target.astype(np.float64)).astype(np.float32)
    out = base.copy()
    found = np.zeros(base.shape, bool)
    for j in sorted(range(-64, 65), key=abs):
        if found.all():
            break
        cand = base.view(np.int32) + np.int32(j)
        cand = cand.view(np.float32)
        hit = ~found & (np.asarray(jnp.exp(jnp.asarray(cand))) == target)
        out[hit] = cand[hit]
        found |= hit
    assert found.all()
    return out


def _state_in(values, fmt, posit_state):
    """A seeded f32 state -> its stored form (posit bits, f32 round-tripped
    through fmt, or f32)."""
    if posit_state:
        return _port_encode(values, fmt)
    if fmt is not None:
        return _codec_rt(values, fmt)
    return values


@pytest.mark.parametrize("T", [1, 7, 16, 130])
@pytest.mark.parametrize("mode", STATE_MODES, ids=[m[0] for m in STATE_MODES])
def test_wkv_model_matches_reference(mode, T):
    """The model of K12's order against repro's wkv_scan_ref: the final
    state bit-identical (the idle slot's bits as they came), y within the
    f32 bound, y = 0 past num_new."""
    import jax.numpy as jnp
    from repro.kernels.recurrent_scan import wkv_scan_ref
    from repro_torch.kernels import recurrent_scan as RS
    name, fmt, posit_state = mode
    rng = np.random.default_rng(100 + T)
    B, H = 4, 2
    r, k, v, logw, u, s = _wkv_inputs(rng, B, H, T)
    k, v, logw = _bits12(k), _bits12(v), _exact_decays(logw)
    nn = np.array([T, 0, max(T - 3, 1), min(T, 17)], np.int32)
    s0 = _state_in(s, fmt, posit_state)
    e = np.asarray(jnp.exp(jnp.asarray(logw)))
    y, sf = wkv_model(r, k, v, e, u, s0, nn, fmt, posit_state,
                      TC=RS.WKV_TC, R=RS.WKV_R)
    y_ref, sf_ref = wkv_scan_ref(*(jnp.asarray(a) for a in
                                   (r, k, v, logw, u, s0)),
                                 jnp.asarray(nn), cfg_state=_ref_cfg(fmt),
                                 posit_state=posit_state)
    _check_wkv(name, T, y, sf, np.asarray(y_ref), np.asarray(sf_ref),
               (r, k, v, e, u), s0, nn, fmt, posit_state)


@pytest.mark.parametrize("T", [7, 130])
@pytest.mark.parametrize("mode", STATE_MODES, ids=[m[0] for m in STATE_MODES])
def test_wkv_model_matches_plain(mode, T):
    """The same model on full-f32 inputs against the port's plain K12
    (`ref.wkv_scan_ref`, what the kernel is held to on the card): the state
    bit-identical, y within the bound."""
    from repro_torch.kernels import recurrent_scan as RS
    from repro_torch.kernels import ref
    name, fmt, posit_state = mode
    rng = np.random.default_rng(300 + T)
    B, H = 4, 2
    r, k, v, logw, u, s = _wkv_inputs(rng, B, H, T)
    nn = np.array([0, T, min(T, 16), max(T - 1, 1)], np.int32)
    s0 = _state_in(s, fmt, posit_state)
    e = torch.exp(torch.from_numpy(logw)).numpy()
    y, sf = wkv_model(r, k, v, e, u, s0, nn, fmt, posit_state,
                      TC=RS.WKV_TC, R=RS.WKV_R)
    y_p, sf_p = ref.wkv_scan_ref(*(torch.from_numpy(a.copy()) for a in
                                   (r, k, v, logw, u, s0, nn)),
                                 cfg_state=_port_cfg(fmt),
                                 posit_state=posit_state)
    _check_wkv(name, T, y, sf, y_p.numpy(), sf_p.numpy(), (r, k, v, e, u),
               s0, nn, fmt, posit_state)


def _check_wkv(name, T, y, sf, y_ref, sf_ref, rkveu, s0, nn, fmt,
               posit_state):
    assert sf.dtype == sf_ref.dtype
    same = sf.view(np.uint8) == sf_ref.view(np.uint8)
    assert same.all(), f"{name} T={T}: {(~same).sum()} state bytes differ"
    idle = int(np.flatnonzero(nn == 0)[0])
    np.testing.assert_array_equal(sf[idle].view(np.uint8),
                                  s0[idle].view(np.uint8))
    s0f = _port_decode(s0, fmt) if posit_state else s0
    tol = _wkv_y_bound(*rkveu, s0f, nn, fmt)
    err = np.abs(y.astype(np.float64) - y_ref)
    assert (err <= tol).all(), f"{name} T={T}: max err/bound " \
        f"{(err / np.maximum(tol, 1e-300)).max():.3g}"
    for b in range(len(nn)):
        assert not y[b, :, nn[b]:].any()


def rglru_model(a, b, h0, nn, fmt, posit_state):
    """K13's chain per channel: h <- rt(a h + b) on the direct round trip;
    the final h encoded once (as the kernel's store)."""
    B, T, d = a.shape
    hs = np.zeros_like(a)
    h_out = np.empty_like(h0)
    for bb in range(B):
        live = min(max(int(nn[bb]), 0), T)
        if live == 0:
            h_out[bb] = h0[bb]
            continue
        h = (_port_decode(h0[bb], fmt) if posit_state
             else h0[bb].astype(np.float32))
        for t in range(live):
            x = a[bb, t] * h + b[bb, t]
            h = rt_mirror(x, *fmt) if fmt is not None else x
            hs[bb, t] = h
        h_out[bb] = _port_encode(h, fmt) if posit_state else h
    return hs, h_out


def _rglru_inputs(rng, B, T, d, fmt, posit_state):
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, d)) - 2.0))
         ).astype(np.float32)
    b = (rng.standard_normal((B, T, d)) * 0.3).astype(np.float32)
    h0 = _state_in(rng.standard_normal((B, d)).astype(np.float32), fmt,
                   posit_state)
    return a, b, h0


RT_MODES = [m for m in STATE_MODES if m[1] is not None]


@pytest.mark.parametrize("T", [1, 37, 130])
@pytest.mark.parametrize("mode", RT_MODES, ids=[m[0] for m in RT_MODES])
def test_rglru_model_matches_reference(mode, T):
    """K13's chain on the direct round trip against repro's
    rglru_scan_ref, a of 12 significant bits (a h exact: h is a posit
    value): the h sequence and the final state bit-identical.  Without a
    round trip h carries 24 bits, XLA's fma(a, h, b) rounds once where
    the kernel rounds twice, and the f32 mode is held to the port's plain
    version below."""
    import jax.numpy as jnp
    from repro.kernels.recurrent_scan import rglru_scan_ref
    name, fmt, posit_state = mode
    rng = np.random.default_rng(200 + T)
    a, b, h0 = _rglru_inputs(rng, 4, T, 96, fmt, posit_state)
    a = _bits12(a)
    nn = np.array([T, 0, max(T - 1, 1), min(T, 5)], np.int32)
    hs, hf = rglru_model(a, b, h0, nn, fmt, posit_state)
    hs_ref, hf_ref = rglru_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(h0), jnp.asarray(nn),
                                    cfg_state=_ref_cfg(fmt),
                                    posit_state=posit_state)
    np.testing.assert_array_equal(hs.view(U32), np.asarray(hs_ref).view(U32))
    np.testing.assert_array_equal(hf.view(np.uint8),
                                  np.asarray(hf_ref).view(np.uint8))


@pytest.mark.parametrize("T", [1, 37, 130])
@pytest.mark.parametrize("mode", STATE_MODES, ids=[m[0] for m in STATE_MODES])
def test_rglru_model_matches_plain(mode, T):
    """K13's chain on full-f32 inputs against the port's plain K13
    (`ref.rglru_scan_ref`): the h sequence and final state bit-identical,
    the idle slot's bits as they came."""
    from repro_torch.kernels import ref
    name, fmt, posit_state = mode
    rng = np.random.default_rng(400 + T)
    a, b, h0 = _rglru_inputs(rng, 4, T, 96, fmt, posit_state)
    nn = np.array([T, 0, max(T - 1, 1), min(T, 5)], np.int32)
    hs, hf = rglru_model(a, b, h0, nn, fmt, posit_state)
    hs_p, hf_p = ref.rglru_scan_ref(*(torch.from_numpy(x.copy()) for x in
                                      (a, b, h0, nn)),
                                    cfg_state=_port_cfg(fmt),
                                    posit_state=posit_state)
    np.testing.assert_array_equal(hs.view(U32), hs_p.numpy().view(U32))
    np.testing.assert_array_equal(hf.view(np.uint8),
                                  hf_p.numpy().view(np.uint8))
    np.testing.assert_array_equal(hf[1].view(np.uint8),
                                  h0[1].view(np.uint8))


# ---- the plan constants ---------------------------------------------------
def test_scan_plan_constants_mirror_the_source():
    from repro_torch.kernels import recurrent_scan as RS
    text = (SRC / "csrc" / "recurrent_scan.cu").read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k(?:Wkv|Rg)\w+) = (\d+);", text)}
    assert consts == {
        "kWkvR": RS.WKV_R, "kWkvRows": RS.WKV_ROWS, "kWkvCols": RS.WKV_COLS,
        "kWkvThreads": RS.WKV_THREADS, "kWkvTC": RS.WKV_TC,
        "kWkvMinBlocks": RS.WKV_MIN_BLOCKS,
        "kWkvSmemBytes": RS.WKV_SMEM_BYTES,
        "kRgChannels": RS.RG_CHANNELS, "kRgThreads": RS.RG_THREADS,
        "kRgDepth": RS.RG_DEPTH, "kRgSmemBytes": RS.RG_SMEM_BYTES}
    assert RS.WKV_R * RS.WKV_ROWS == 64
    assert RS.WKV_COLS * RS.WKV_R == RS.WKV_THREADS
    # rwkv6-3b's 8 x 40 heads of 64: 640 blocks, 4.85 an SM of 132, and 5
    # fit by shared memory (228 KB an SM) and by registers
    assert 8 * 40 * (64 // RS.WKV_COLS) == 640
    assert RS.WKV_MIN_BLOCKS * RS.WKV_SMEM_BYTES <= 233472
    assert RS.WKV_SMEM_BYTES <= 48 * 1024           # static shared memory
    assert RS.RG_SMEM_BYTES <= 48 * 1024
    # recurrentgemma-9b's 8 x 4,096 channels: 128 blocks, one an SM
    assert 8 * 4096 // (RS.RG_THREADS * RS.RG_CHANNELS) == 128
