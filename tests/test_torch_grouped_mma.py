"""K10 and K11 (`csrc/grouped_gemm.cu`) on the CPU: the launch plan and a
plain model of each form's summation.

The CUDA kernels run only on the card (`chip_smoke.py` holds them against
their plain versions there, every posit pattern bit for bit at K = 1);
these tests pin what their design rests on:

- `grouped_plan` (the mirror of `make_grouped_plan` / `make_dw_plan`)
  picks the decode form for posit experts below 16 rows a group and the
  tiled form otherwise, and fits the card at every MoE shape the port's
  configs launch (olmoe-1b-7b's decode, prefill and training steps, and
  its smoke config) and at the card checks' edge layouts;
- a plain model of each form's sums: the decode form is K2's skinny
  stream over one group's rows (lanes by FFMA in increasing k, the block's
  k-lanes in a fixed order, k-chunks in order); the tiled forms are K2's
  tensor-core sums over exact bf16 pieces, per group (K10) or over the
  group's rows as k from offsets[e] (K11).  Each stays within the f32
  dot-product bound 2 Kc 2^-24 (|x| @ |w|) of the plain version (plus the
  declared 2^-22 (|x| @ |w|) for f32 x f32), with empty groups, a group
  holding every row, boundaries inside a tile and rows past offsets[E].
"""
from __future__ import annotations

import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_gemm_pieces import kernel_model  # noqa: E402
from test_torch_skinny import skinny_model  # noqa: E402

H100_SMEM = 232_448           # dynamic shared bytes a block may opt into
TAB_BYTES = 256 * 4           # the decode form's static table
TRAIN_TOKENS = 8 * 512
PREFILL_TOKENS = (1, 44, 127, 128, 512, 1024)   # a prefill step's tokens
MAX_SEQS = 8


# ---- (a) the launch plan ----------------------------------------------------
def _moe_shapes(cfg):
    """(name, K, N) of an MoE layer's expert tables: up and gate [d, f],
    down [f, d]."""
    d, f = cfg.d_model, cfg.d_ff
    return [("up/gate", d, f), ("down", f, d)]


def _check_plan(S, N, K, E, eb, tb=False, dw=False):
    from repro_torch.kernels import grouped_gemm as GG
    p = GG.grouped_plan(S, N, K, E, eb, tb, dw)
    assert 0 < p.smem and p.smem % 16 == 0
    if dw or eb == 4 or S >= GG.STREAM_ROWS * E:
        assert p.form == "mma"
        want = 128 if dw or S >= GG.BIG_TILE_ROWS * E else 64
        assert (p.bm, p.bn) == (want, want)
        assert p.threads == (256 if want == 128 else 128)
        assert p.smem <= H100_SMEM
        return p
    assert p.form == "stream"
    cpt, kpg = (4, 16 // eb) if tb else (16 // eb, 1)
    assert (p.bm, p.bn, p.threads) == (8, 128, 256)
    assert p.tn * cpt == p.bn and p.tn * p.tk == p.threads
    assert p.tk % 2 == 0 and (not tb or p.tn % 8 == 0)
    ng = -(-max(K, 1) // kpg)
    assert (p.nch - 1) * p.chunk < ng <= p.nch * p.chunk
    # staged x of a chunk at 8 rows fits the shared region beside the ring
    assert 4 * p.chunk * kpg * 8 <= p.smem
    assert p.smem + TAB_BYTES <= H100_SMEM
    return p


@pytest.mark.parametrize("smoke", [False, True])
def test_grouped_plan_every_moe_shape(smoke):
    """olmoe-1b-7b (and its smoke config) at every decode step (1..8
    sequences), prefill steps of 1..1,024 tokens, and the training step's
    forward, dX and dW, for posit16, posit8 and f32 experts."""
    from repro_torch import configs
    cfg = (configs.get_smoke if smoke else configs.get_config)(
        "olmoe-1b-7b")
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    forms = set()
    for _, K, N in _moe_shapes(cfg):
        for eb in (2, 1, 4):
            for n in range(1, MAX_SEQS + 1):            # decode steps
                forms.add(_check_plan(n * k, N, K, E, eb).form)
            for t in PREFILL_TOKENS:                    # prefill steps
                forms.add(_check_plan(t * k, N, K, E, eb).form)
        S = TRAIN_TOKENS * k                            # training
        _check_plan(S, N, K, E, 4)
        _check_plan(S, K, N, E, 4, tb=True)             # dX
        _check_plan(S, N, K, E, 4, dw=True)             # dW
    assert forms == {"stream", "mma"}


def test_grouped_plan_values():
    """The numbers the C plan is written to return at olmoe's shapes."""
    from repro_torch.kernels import grouped_gemm as GG
    P = GG.grouped_plan
    # decode: 64 rows over 64 experts; x staged 1,024 k at a time at 8 rows
    assert P(64, 1024, 2048, 64, 2) == GG.GroupedPlan(
        "stream", 8, 128, 256, 65664, 16, 16, 1024, 2)
    assert P(64, 2048, 1024, 64, 2) == GG.GroupedPlan(
        "stream", 8, 128, 256, 65664, 16, 16, 1024, 1)
    assert P(64, 2048, 1024, 64, 2, True) == GG.GroupedPlan(
        "stream", 8, 128, 256, 81920, 32, 8, 128, 1)
    assert P(64, 1024, 2048, 64, 1) == GG.GroupedPlan(
        "stream", 8, 128, 256, 98560, 8, 32, 1024, 2)
    # tiled: prefill (128 rows a group), training, the edge checks' 2,000
    mma = GG.GroupedPlan
    assert P(8192, 1024, 2048, 64, 2) == mma("mma", 128, 128, 256, 96256,
                                             0, 0, 0, 0)
    assert P(32768, 1024, 2048, 64, 4) == mma("mma", 128, 128, 256, 113664,
                                              0, 0, 0, 0)
    assert P(32768, 2048, 1024, 64, 4, True) == mma("mma", 128, 128, 256,
                                                    122880, 0, 0, 0, 0)
    assert P(2000, 1024, 2048, 64, 2) == mma("mma", 64, 64, 128, 49152,
                                             0, 0, 0, 0)
    assert P(64, 1024, 2048, 64, 4) == mma("mma", 64, 64, 128, 58368,
                                           0, 0, 0, 0)
    assert P(32768, 1024, 2048, 64, dw=True) == mma("mma", 128, 128, 256,
                                                    104448, 0, 0, 0, 0)
    # the threshold: 16 rows a group on average
    assert P(1023, 1024, 2048, 64, 2).form == "stream"
    assert P(1024, 1024, 2048, 64, 2).form == "mma"


def test_grouped_plan_is_cached_and_mirrors_the_source():
    """Cached per shape (an uncached plan cost host time on every decode
    step), and the plan constants equal the source's."""
    from repro_torch.kernels import grouped_gemm as GG
    GG.grouped_plan(64, 1024, 2048, 64, 2)
    hits = GG.grouped_plan.cache_info().hits
    GG.grouped_plan(64, 1024, 2048, 64, 2)
    assert GG.grouped_plan.cache_info().hits == hits + 1
    src = (Path(GG.__file__).resolve().parents[1] / "csrc" /
           "grouped_gemm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert (const("kStreamRows"), const("kStreamBM"), const("kStreamBN"),
            const("kBigTileRows")) == (GG.STREAM_ROWS, GG.STREAM_BM,
                                       GG.STREAM_BN, GG.BIG_TILE_ROWS)
    assert re.search(r"FORM_STREAM = (\d+), FORM_MMA = (\d+)",
                     src).groups() == (str(GG.FORMS["stream"]),
                                       str(GG.FORMS["mma"]))


# ---- (b) the summation of each form ------------------------------------------
E_SMALL, K_SMALL, N_SMALL = 8, 64, 48
LAYOUTS = {
    "random": None,
    "empty groups": [0, 5, 0, 0, 12, 0, 3, 0],
    "one group holds every row": [0, 0, 40, 0, 0, 0, 0, 0],
    "boundaries inside a tile": [17, 1, 0, 15, 2, 0, 3, 2],
    "rows past offsets[E]": [3, 0, 9, 1, 0, 4, 0, 0],
}
S_SMALL = 40


def _offsets(layout, rng):
    if layout is None:
        ids = np.sort(rng.integers(0, E_SMALL, S_SMALL))
        sizes = np.bincount(ids, minlength=E_SMALL)
    else:
        sizes = np.array(layout)
    return torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(
        np.int32))


def _bounds(off, S):
    o = off.tolist()
    return [(min(max(a, 0), S), min(max(b, min(max(a, 0), S)), S))
            for a, b in zip(o[:-1], o[1:])]


def grouped_model(x, wf, off, form, plan, pb):
    """x [S, Kc] @ wf[g] ([E, Kc, N] values, the stored table read in the
    kernel's orientation) as the chosen form sums each group's rows; rows
    outside every group 0."""
    S = x.shape[0]
    out = torch.zeros((S, wf.shape[2]), dtype=torch.float32)
    for g, (a, b) in enumerate(_bounds(off, S)):
        if b <= a:
            continue
        if form == "stream":
            out[a:b] = skinny_model(x[a:b], wf[g], plan)
        else:
            out[a:b] = kernel_model(x[a:b], wf[g], 3, pb)
    return out


def _stream_plan(Kc, eb, tb, chunk=None):
    """The decode form's lanes and chunks as skinny_model reads them (one
    block over the whole k range: no cluster split)."""
    from repro_torch.kernels import grouped_gemm as GG
    p = GG.grouped_plan(8, 128, Kc, E_SMALL, eb, tb)
    kpg = 16 // eb if tb else 1
    ng = -(-Kc // kpg)
    chunk = chunk or p.chunk
    return types.SimpleNamespace(tk=p.tk, kpg=kpg, chunk=chunk,
                                 nch=-(-ng // chunk), splits=1, per=ng)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("fmt", ["p16", "p8", "f32"])
@pytest.mark.parametrize("tb", [False, True])
def test_grouped_forms_within_bound_of_plain(layout, fmt, tb):
    """Both forms for posit experts (the decode form also with x staged in
    k-chunks of 16 groups), the tiled form for f32 experts, against
    `ref.grouped_matmul_ref`."""
    from repro_torch.core.types import P8_2, P16_2
    from repro_torch.kernels import ref
    cfg = {"p16": P16_2, "p8": P8_2, "f32": None}[fmt]
    rng = np.random.default_rng(len(layout) * 7 + len(fmt) + tb)
    off = _offsets(LAYOUTS[layout], rng)
    w = torch.from_numpy((rng.standard_normal(
        (E_SMALL, K_SMALL, N_SMALL)) * K_SMALL ** -0.5).astype(np.float32))
    if cfg is not None:
        w = ref.encode_ref(w, cfg)
    kc = N_SMALL if tb else K_SMALL
    x = torch.from_numpy(rng.standard_normal((S_SMALL, kc)).astype(
        np.float32))
    vals = ref.values(w, cfg)
    wf = vals.transpose(1, 2).contiguous() if tb else vals   # [E, Kc, N]
    want = ref.grouped_matmul_ref(x, w, off, cfg_b=cfg, transpose_b=tb)
    s = ref.grouped_matmul_ref(x.abs(), vals.abs(), off,
                               transpose_b=tb).double()
    tol = (2 * kc * 2.0 ** -24 + (2.0 ** -22 if cfg is None else 0.0)) * s
    eb = w.element_size()
    models = [("mma", None)]
    if cfg is not None:
        models += [("stream", _stream_plan(kc, eb, tb)),
                   ("stream", _stream_plan(kc, eb, tb, chunk=2))]
    _, inb = ref.grouped_row_ids(off, S_SMALL)
    for form, plan in models:
        got = grouped_model(x, wf, off, form, plan, 3 if cfg is None else 2)
        diff = (got.double() - want.double()).abs()
        assert bool((diff <= tol).all()), (form, float((diff / (
            tol + 1e-300)).max()))
        assert bool((got[~inb] == 0).all())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_grouped_dw_within_bound_of_plain(layout):
    """K11's sums: x^T g over each group's rows as k, 16-deep steps from
    offsets[e], f32 x f32 pieces; an empty group exactly 0."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(len(layout))
    off = _offsets(LAYOUTS[layout], rng)
    x = torch.from_numpy(rng.standard_normal((S_SMALL, K_SMALL)).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((S_SMALL, N_SMALL)).astype(
        np.float32))
    got = torch.zeros((E_SMALL, K_SMALL, N_SMALL), dtype=torch.float32)
    for e, (a, b) in enumerate(_bounds(off, S_SMALL)):
        if b > a:
            got[e] = kernel_model(x[a:b].T.contiguous(), g[a:b], 3, 3)
    want = ref.grouped_matmul_dw_ref(x, g, off)
    n_e = torch.tensor([b - a for a, b in _bounds(off, S_SMALL)],
                       dtype=torch.float64)
    tol = (2 * n_e[:, None, None] * 2.0 ** -24 + 2.0 ** -22) * \
        ref.grouped_matmul_dw_ref(x.abs(), g.abs(), off).double()
    diff = (got.double() - want.double()).abs()
    assert bool((diff <= tol).all()), float((diff / (tol + 1e-300)).max())
    assert bool((got[n_e == 0] == 0).all())


def test_grouped_models_k1_are_the_decoded_weight():
    """At K = 1 and x = 1 both forms give each weight itself, bit for bit:
    the card's exhaustive decode check through both forms rests on this."""
    from repro_torch.core.types import P16_2
    from repro_torch.kernels import ref
    p = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16)
    wf = ref.decode_ref(p, P16_2)[None, None, :]
    off = torch.tensor([0, 2], dtype=torch.int32)
    fin = torch.isfinite(wf[0, 0])
    for form, plan in (("stream", _stream_plan(1, 2, False)), ("mma", None)):
        got = grouped_model(torch.ones((2, 1)), wf, off, form, plan, 2)
        assert torch.equal(got[:, fin].view(torch.int32),
                           wf[0, :, fin].expand(2, -1).view(torch.int32))
        assert torch.isnan(got[:, ~fin]).all()


# ---- (c) the CPU wrapper ------------------------------------------------------
@pytest.mark.parametrize("tb", [False, True])
def test_grouped_gemm_cpu_runs_plain_and_counts_no_launch(tb):
    from repro_torch.core.types import P16_2
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.kernels import ops, ref
    ops.reset_counters()
    off = torch.tensor([0, 3, 3, 10], dtype=torch.int32)
    w = ref.encode_ref(torch.randn(3, 33, 20), P16_2)
    x = torch.randn(12, 20 if tb else 33)
    got = GG.posit_grouped_gemm(x, w, off, P16_2, transpose_b=tb)
    assert torch.equal(got, GG.posit_grouped_gemm_plain(x, w, off, P16_2,
                                                        tb))
    dw = GG.posit_grouped_gemm_dw(x, torch.randn(12, 7), off)
    assert dw.shape == (3, x.shape[1], 7) and bool((dw[1] == 0).all())
    counts, plain = ops.launch_counts(), ops.plain_counts()
    assert counts["grouped_gemm"] == counts["grouped_gemm_dw"] == 0
    assert GG.posit_grouped_gemm.stream_launches == 0
    assert plain["grouped_gemm"] == 2 and plain["grouped_gemm_dw"] == 1
