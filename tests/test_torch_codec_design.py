"""K1's design on the CPU (``csrc/posit_codec.cu``), against `repro`.

The kernels run only on a GPU; these tests hold what they compute:

- `encode_mirror`, a numpy mirror of the table encode (posit_codec.cuh's
  `encode_table_fill`, `encode_tab` and `encode_fix`: on the binades where
  the pattern keeps a fraction bit, the rounded value x + M - M read
  through two 256-entry tables; elsewhere the general encode), bit for bit
  against `repro.core.convert.f32_to_posit` for P16_2, P8_2 and four
  formats the kernels take at run time (es 0 to 3): every pattern's
  value, every midpoint of neighbours and its two f32 neighbours, every
  f32 exponent with seeded mantissas, +-0, +-subnormals, +-Inf, NaN, and
  values past maxpos and minpos;
- the passes' split into a head of lanes, steps of one float4 and a tail
  (`posit_codec.codec_split`, mirrored by the source's), walked over
  ragged lengths and misaligned addresses: every element once, every
  step aligned on both sides, the result bit for bit `repro`'s; and the
  int8 decode's 256-entry table against `repro.core.decode.decode_to_f32`;
- `round_trip_block_plain` (and through it the port's `posit_cast_ste`
  and `rt_values`) against `repro`'s `posit_cast_ste` forward and
  `rt_values`;
- a plain model of the append by token rows (b, h, s, the mask, the page
  and the offset once a row; the row's lanes in chunks of 4) against
  ``repro/serving/paged_kv.py::paged_append_kv`` and the port's plain
  version;
- the Python mirror of the plan constants against the source.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
# compiled formats first, then runtime ones with es 0 to 3
FORMATS = [(16, 2), (8, 2), (16, 1), (8, 0), (12, 3), (6, 1)]
IDS = [f"p{n}e{es}" for n, es in FORMATS]
U32 = np.uint32


def _ref_cfg(fmt):
    from repro.core.types import PositConfig
    return PositConfig(*fmt)


def _port_cfg(fmt):
    from repro_torch.core.types import PositConfig
    return PositConfig(*fmt)


def _storage(n):
    return np.int8 if n <= 8 else np.int16


def _ref_encode(x, fmt):
    import jax.numpy as jnp
    from repro.core.convert import f32_to_posit
    return np.asarray(f32_to_posit(jnp.asarray(x), _ref_cfg(fmt)))


def _ref_decode(bits, fmt):
    import jax.numpy as jnp
    from repro.core.decode import decode_to_f32
    return np.asarray(decode_to_f32(jnp.asarray(bits), _ref_cfg(fmt)))


def _port_encode(x, fmt):
    from repro_torch.kernels import ref
    return ref.encode_ref(torch.from_numpy(np.ascontiguousarray(x)),
                          _port_cfg(fmt)).numpy()


# ---- the encode ---------------------------------------------------------
def encode_tables(n, es):
    """numpy mirror of `encode_table_fill` (posit_codec.cuh): m[t], the
    bits of |M| for an f32 of biased exponent t (0 off the fast binades),
    and f[t], the pattern of 2^(t - 127) in bits 31:16 over the fraction's
    right shift 23 - (fraction bits) in bits 4:0, where te = t - 127 lies
    in [-span, span]."""
    t = np.arange(256, dtype=np.int64)
    span = (n - 3 - es) * (1 << es)
    lo, hi = max(127 - span, 1), min(126 + span, 232)
    k = (t - 127) >> es
    sh = 26 - n + es + np.where(k >= 0, k, -k - 1)
    m = np.where((t >= lo) & (t <= hi), (t + sh) << 23, 0)
    te = t - 127
    rlen = np.where(k >= 0, k + 2, 1 - k)
    fbits = n - 1 - rlen - es
    pat = _port_encode((t << 23).astype(U32).view(np.float32),
                       (n, es)).astype(np.int64)
    on = (t >= 1) & (t <= 254) & (te >= -span) & (te <= span)
    f = np.where(on, (pat << 16) | (23 - fbits), 0)
    return m, f


def fast_lanes(x, n, es):
    """The lanes `encode_tab` encodes by the tables (m[ex] != 0)."""
    ex = (x.view(U32).astype(np.int64) >> 23) & 0xFF
    return encode_tables(n, es)[0][ex] != 0


def encode_mirror(x, n, es):
    """numpy mirror of `encode_tab` and `encode_fix` (posit_codec.cuh): y =
    x + M - M in f32 with M = sign(x) |M|, |M| from m[x's exponent]; the
    pattern f[y's exponent] >> 16 plus y's 23 fraction bits shifted right
    by f's low 5 bits, negated for a negative x; the lanes whose m entry
    is 0 by the general encode (the port's plain version, bit for bit
    posit_encode's)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    tm, tf = encode_tables(n, es)
    b = x.view(U32).astype(np.int64)
    m = tm[(b >> 23) & 0xFF]
    M = (m | (b & 0x80000000)).astype(U32).view(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        y = ((x + M) - M).view(U32).astype(np.int64)
    f = tf[(y >> 23) & 0xFF]
    body = (f >> 16) + ((y & 0x7FFFFF) >> (f & 31))
    out = np.where(b >> 31, -body, body)
    slow = m == 0
    if slow.any():
        out[slow] = _port_encode(x[slow], (n, es)).astype(np.int64)
    return out.astype(_storage(n))


def codec_inputs(n, es, seed=0):
    """Every pattern's value, the midpoints of neighbours and their f32
    neighbours, every f32 exponent with seeded mantissas (both signs), the
    specials, subnormals, and values past maxpos and minpos."""
    pats = np.arange(-(1 << (n - 1)), 1 << (n - 1), dtype=np.int32)
    vals = _ref_decode(pats, (n, es))
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


@pytest.mark.parametrize("fmt", FORMATS, ids=IDS)
def test_encode_mirror_matches_repro(fmt):
    n, es = fmt
    x = codec_inputs(n, es)
    got = encode_mirror(x, n, es)
    want = _ref_encode(x, fmt)
    assert got.dtype == want.dtype
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, (
        f"{fmt}: {bad.size} of {x.size} differ, first x = {x[bad[0]]!r} "
        f"({x.view(U32)[bad[0]]:#010x}): {got[bad[0]]} against "
        f"{want[bad[0]]}")
    fast = fast_lanes(x, n, es)
    assert fast.any() and not fast.all()          # both paths exercised


def test_encode_fast_path_covers_the_carry_and_the_binade_edges():
    """The fast lanes' edges: te in [-44, 44] for P16_2 (the top binade's
    round-up carries into te = 44, still a fraction-free pattern), and
    the values whose rounding carries into the next binade and the next
    regime encode as repro does."""
    te = np.arange(-126, 128)
    x = np.ldexp(np.float32(1.5), te).astype(np.float32)
    fast = fast_lanes(x, 16, 2)
    assert te[fast].min() == -44 and te[fast].max() == 43
    # just below a power of two at every binade: rounds up into 2^(te+1)
    below = np.nextafter(np.ldexp(np.float32(1.0), np.arange(-43, 45)),
                         np.float32(0)).astype(np.float32)
    for fmt in ((16, 2), (8, 2)):
        got = encode_mirror(np.concatenate([below, -below]), *fmt)
        want = _ref_encode(np.concatenate([below, -below]), fmt)
        np.testing.assert_array_equal(got, want)


# ---- the passes' split ---------------------------------------------------
def walk(count, f32_addr, other_addr, other_bytes):
    """The elements of one pass as the kernel walks them: (lane elements,
    [step start elements]) from `codec_split`, each step of 4 elements
    checked aligned on both sides (a float4; 4 posits, or a float4)."""
    from repro_torch.kernels.posit_codec import codec_split
    head, nvec = codec_split(count, f32_addr, other_addr, other_bytes)
    starts = head + 4 * np.arange(nvec)
    for e in starts[:3].tolist() + starts[-2:].tolist():
        assert (f32_addr + 4 * e) % 16 == 0
        assert (other_addr + other_bytes * e) % (4 * other_bytes) == 0
    lanes = np.concatenate([np.arange(head),
                            np.arange(head + 4 * nvec, count)])
    return lanes.astype(np.int64), starts


@pytest.mark.parametrize("other_bytes", [1, 2, 4],
                         ids=["posit8", "posit16", "round_trip"])
def test_split_walks_every_element_once(other_bytes):
    """Over lengths around a step and every alignment of either side:
    the lanes and the steps cover [0, count) once; with both sides
    aligned alike a head of lanes precedes the steps and the tail is
    shorter than a step; with the sides out of phase everything is a
    lane."""
    base = 1 << 20
    saw_head = saw_all_lanes = False
    for count in (0, 1, 3, 4, 5, 7, 8, 9, 16, 17, 31, 100, 1000, 4099):
        for f_off in range(0, 16, 4):
            for o_off in range(0, 16, other_bytes):
                lanes, starts = walk(count, base + f_off, base + o_off,
                                     other_bytes)
                cover = np.zeros(count, np.int64)
                np.add.at(cover, lanes, 1)
                for s in starts:
                    cover[s:s + 4] += 1
                assert (cover == 1).all(), (count, f_off, o_off)
                if starts.size:
                    assert 0 <= count - (starts[-1] + 4) < 4
                    assert 0 <= starts[0] < 4
                    saw_head |= starts[0] > 0
                else:
                    saw_all_lanes |= lanes.size == count > 4
    assert saw_head and saw_all_lanes


@pytest.mark.parametrize("fmt", [(16, 2), (8, 2), (12, 3)],
                         ids=["p16e2", "p8e2", "p12e3"])
def test_encode_pass_through_the_split_matches_repro(fmt):
    """The encode pass walked as the kernel walks it (head lanes, steps of
    one float4, the tail) on a ragged length and misaligned operands: the
    pattern of every element is repro's."""
    n, es = fmt
    x = codec_inputs(n, es)[:40_003]
    nb = np.dtype(_storage(n)).itemsize
    want = _ref_encode(x, fmt)
    for f_off, o_off in ((0, 0), (4, 3 * nb), (12, nb), (8, 0)):
        out = np.zeros(x.size, _storage(n))
        lanes, starts = walk(x.size, 4096 + f_off, 8192 + o_off, nb)
        out[lanes] = encode_mirror(x[lanes], n, es)
        for s in starts:
            out[s:s + 4] = encode_mirror(x[s:s + 4], n, es)
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("fmt", [(8, 2), (8, 0), (6, 1)],
                         ids=["p8e2", "p8e0", "p6e1"])
def test_int8_decode_table_matches_repro(fmt):
    """The int8 decode's table: entry i is the decode of int8(i), read at
    uint8(p); over every int8 pattern it is repro's decode, NaR's NaN
    included."""
    from repro_torch.kernels import ref
    idx = np.arange(256).astype(np.uint8).view(np.int8)
    tab = ref.decode_ref(torch.from_numpy(idx), _port_cfg(fmt)).numpy()
    pats = np.arange(-128, 128, dtype=np.int32).astype(np.int8)
    got = tab[pats.view(np.uint8)]
    want = _ref_decode(pats, fmt)
    np.testing.assert_array_equal(got.view(U32), want.view(U32))


# ---- the round trip --------------------------------------------------------
@pytest.mark.parametrize("fmt", FORMATS, ids=IDS)
def test_round_trip_plain_matches_repro_cast_and_rt_values(fmt):
    """round_trip_block's plain version is repro's posit_cast_ste forward
    and rt_values, bit for bit (NaR as the same NaN), and the port's
    posit_cast_ste and rt_values reach it in one call each, on the CPU
    with no launch."""
    import jax.numpy as jnp
    from repro.models.blocks import rt_values as ref_rt_values
    from repro.quant.policy import posit_cast_ste as ref_ste
    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_codec import round_trip_block_plain
    from repro_torch.models.blocks import rt_values
    from repro_torch.quant.policy import posit_cast_ste
    n, es = fmt
    x = codec_inputs(n, es)
    want = np.asarray(ref_ste(jnp.asarray(x), _ref_cfg(fmt))).view(U32)
    np.testing.assert_array_equal(
        np.asarray(ref_rt_values(jnp.asarray(x), _ref_cfg(fmt))).view(U32),
        want)
    tx, cfg = torch.from_numpy(x), _port_cfg(fmt)
    np.testing.assert_array_equal(
        round_trip_block_plain(tx, cfg).numpy().view(U32), want)
    ops.reset_counters()
    np.testing.assert_array_equal(posit_cast_ste(tx, cfg).numpy().view(U32),
                                  want)
    np.testing.assert_array_equal(rt_values(tx, cfg).numpy().view(U32), want)
    assert ops.plain_counts()["round_trip_block"] == 2
    assert ops.plain_counts()["encode_block"] == 0
    assert ops.plain_counts()["decode_block"] == 0
    assert sum(ops.launch_counts().values()) == 0


# ---- the append by token rows -----------------------------------------------
def append_lanes(D):
    """Lanes of a row (the source's LPR): the power of two holding D / 4
    chunks of 4, at most 32."""
    lpr = 1
    while lpr < 32 and 4 * lpr < D:
        lpr *= 2
    return lpr


def append_rows_model(k, v, kp, vp, table, seq_lens, num_new, enc):
    """The kernel's walk, in numpy: one (b, h, s) row at a time, its mask,
    page and offset found once; the row's 4-element chunks spread over
    its lanes (d = 4 lane + 4 LPR j), each chunk encoded and stored."""
    B, n_kv, S, D = k.shape
    P, _, page, _ = kp.shape
    W = table.shape[1]
    lpr = append_lanes(D)
    chunks = [d for lane in range(lpr) for d in range(4 * lane, D, 4 * lpr)]
    assert sorted(chunks) == list(range(0, D, 4))
    for row in range(B * n_kv * S):
        s, bh = row % S, row // S
        h, b = bh % n_kv, bh // n_kv
        if s >= num_new[b]:
            continue
        pos = int(seq_lens[b]) + s
        slot = pos // page
        if slot >= W:
            continue
        pg = int(table[b, slot])
        if pg < 0 or pg >= P:
            continue
        off = pos % page
        for d in chunks:
            kp[pg, h, off, d:d + 4] = enc(k[b, h, s, d:d + 4])
            vp[pg, h, off, d:d + 4] = enc(v[b, h, s, d:d + 4])


def _append_case(rng, D, S=7):
    B, n_kv, page, W, P = 3, 2, 4, 5, 20
    seq_lens = np.array([0, 9, 14], np.int32)     # slot 2 runs past table
    num_new = np.array([7, 2, 7], np.int32)       # slot 1: a ragged tail
    table = rng.permutation(P)[:B * W].reshape(B, W).astype(np.int32)
    k = rng.standard_normal((B, n_kv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, n_kv, S, D)).astype(np.float32)
    return k, v, table, seq_lens, num_new, (P, n_kv, page, D)


@pytest.mark.parametrize("posit", ["float", "p8", "p16"])
@pytest.mark.parametrize("D", [8, 20, 18])
def test_append_rows_model_matches_repro(posit, D):
    """Masked tokens and positions past the table drop whole rows; table
    entries of -1 in slots no live token reaches (as the engines leave
    them) change nothing; every written row is repro's, bit for bit."""
    import jax.numpy as jnp
    from repro.core.array import PositArray
    from repro.serving.paged_kv import paged_append_kv
    rng = np.random.default_rng(D)
    k, v, table, sl, nn, shape = _append_case(rng, D)
    table[1, 4] = -1                 # slot 1 ends at position 10: slot 2
    fmt = {"p8": (8, 2), "p16": (16, 2)}.get(posit)
    dt = np.float32 if fmt is None else _storage(fmt[0])
    kp = rng.integers(-50, 50, shape).astype(dt)
    vp = rng.integers(-50, 50, shape).astype(dt)
    enc = (lambda a: a) if fmt is None else (lambda a: _ref_encode(a, fmt))
    got_k, got_v = kp.copy(), vp.copy()
    append_rows_model(k, v, got_k, got_v, table, sl, nn, enc)
    wrap = (lambda a: jnp.asarray(a)) if fmt is None else (
        lambda a: PositArray(jnp.asarray(a), _ref_cfg(fmt)))
    want = paged_append_kv({"k_pages": wrap(kp), "v_pages": wrap(vp),
                            "page_table": jnp.asarray(table),
                            "seq_lens": jnp.asarray(sl),
                            "num_new": jnp.asarray(nn)},
                           jnp.asarray(k), jnp.asarray(v))
    for got, key in ((got_k, "k_pages"), (got_v, "v_pages")):
        w = np.asarray(getattr(want[key], "bits", want[key]))
        np.testing.assert_array_equal(got.view(np.uint8), w.view(np.uint8))
    assert not np.array_equal(got_k, kp)         # rows were written


@pytest.mark.parametrize("D", [64, 20, 18])
def test_append_rows_model_matches_the_plain_version(D):
    """Table entries of -1 and past the pool where live tokens land drop
    their rows in the model and in the port's plain version alike."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(100 + D)
    k, v, table, sl, nn, shape = _append_case(rng, D)
    table[0, 1] = -1
    table[2, 3] = shape[0] + 3
    kp = np.zeros(shape, np.int16)
    vp = np.zeros(shape, np.int16)
    got_k, got_v = kp.copy(), vp.copy()
    append_rows_model(k, v, got_k, got_v, table, sl, nn,
                      lambda a: _ref_encode(a, (16, 2)))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    ref.paged_append_ref(torch.from_numpy(k), torch.from_numpy(v), tk, tv,
                         torch.from_numpy(table), torch.from_numpy(sl),
                         torch.from_numpy(nn), _port_cfg((16, 2)))
    np.testing.assert_array_equal(got_k, tk.numpy())
    np.testing.assert_array_equal(got_v, tv.numpy())


# ---- the plan constants ------------------------------------------------------
def test_codec_plan_constants_mirror_the_source():
    from repro_torch.kernels import posit_codec as C
    text = (SRC / "csrc" / "posit_codec.cu").read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", text)}
    assert consts == {"kThreads": C.CODEC_THREADS,
                      "kUnroll": C.STEPS_IN_FLIGHT}
    assert C.CODEC_THREADS == 256                # a table entry a thread
    # the split and the append's lanes, as codec_split and append_lanes
    # compute them
    assert "long long head = static_cast<long long>((16 - fa % 16) % 16) / " \
           "4;" in text
    assert "(pa + static_cast<uintptr_t>(pb) * head) % (4 * pb) != 0" in text
    assert "return {head, (count - head) / 4};" in text
    assert "while (lpr < 32 && 4 * lpr < D) lpr *= 2;" in text
    assert [append_lanes(D) for D in (1, 4, 8, 18, 20, 64, 128, 256)] == \
        [1, 1, 2, 8, 8, 16, 32, 32]
