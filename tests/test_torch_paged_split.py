"""K3's split plan and arithmetic, and K4's paged tile walk, on the CPU.

The kernels run only on a GPU; these tests hold what surrounds them:

- `decode_plan` (the Python mirror of ``csrc/paged_attention.cu::
  make_decode_plan``, which the C entry refuses to contradict) over the
  decode layouts of the served and queued configs at every table width
  1..160: every page owned by exactly one split, S within the cluster
  limit, shared memory within a block's, and the card filled at the chip's
  shapes;
- a plain model of K3's arithmetic (each split's streams of key pairs with
  their own online softmax, combined in stream order, then the splits in
  split order, a partial that saw no key weighing 0) against `repro`'s
  jnp oracle (`serving.paged_kv.paged_attention`: gather_kv and the
  reference attention), over ragged lengths with 0 and 1, exact page
  multiples, a window, all-empty splits, out-of-range table entries and a
  reclaimed garbage page of NaR patterns (NaN for f32), which must not
  reach the output;
- a plain model of K4's tile walk (K7's 64 folded rows over K/V tiles
  read through the page table: which keys a tile stages and which it
  zeroes) against a brute-force mask over windows, causal, q_offset and
  out-of-range entries, and its arithmetic against the same oracle.
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import port_posit  # noqa: E402

# The model and the oracle decode the pages exactly and sum f32 products;
# they differ in summation order (per-stream partials combined by
# rescaling, against one softmax over all keys) and in libm ulps, ~1e-7
# on outputs bounded by max|v| ~ 4.
RTOL = ATOL = 1e-5
NEG = -1e30
SMEM_BLOCK = 232448
SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _decode_layouts():
    """(n_kv, G, head_dim) of the decode attention of the served and
    queued configs."""
    from repro.configs import get_config
    out = {}
    for arch in ("smollm-360m", "olmoe-1b-7b", "recurrentgemma-9b",
                 "gemma-2b"):
        cfg = get_config(arch)
        out[arch] = (cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.hd)
    return out


# ---- K3's plan ------------------------------------------------------------
@pytest.mark.parametrize("elem_bytes", [1, 2, 4])
@pytest.mark.parametrize("arch", ["smollm-360m", "olmoe-1b-7b",
                                  "recurrentgemma-9b", "gemma-2b"])
def test_decode_plan_owns_every_page_once(arch, elem_bytes):
    from repro_torch.kernels import flash_attention as F
    n_kv, G, D = _decode_layouts()[arch]
    assert (G, D) == {"smollm-360m": (3, 64), "olmoe-1b-7b": (1, 128),
                      "recurrentgemma-9b": (16, 256),
                      "gemma-2b": (8, 256)}[arch]
    for B in (1, 8):
        for W in range(1, 161):
            p = F.decode_plan(B, n_kv, W, 16, D, G, elem_bytes)
            assert 1 <= p.splits <= min(F.DEC_MAX_SPLIT, W)
            owned = [j for s in range(p.splits)
                     for j in F.split_pages(s, p.splits, W)]
            assert owned == list(range(W))          # once each, in order
            sizes = [len(F.split_pages(s, p.splits, W))
                     for s in range(p.splits)]
            assert min(sizes) >= 1 and max(sizes) <= p.pages_per_split
            assert 0 < p.smem <= SMEM_BLOCK
            assert p.head_groups * F.DEC_GH >= G
            assert p.head_groups in (1, 2, 4, 8)
            assert 1 <= p.stage_pages <= p.pages_per_split
            if p.splits < min(F.DEC_MAX_SPLIT, W):
                assert B * n_kv * p.splits >= F.DEC_SMS


@pytest.mark.parametrize("shape", [("smollm-360m", 34, 160),
                                   ("recurrentgemma-9b", 34, 128),
                                   ("recurrentgemma-9b", 138, 128)])
def test_decode_plan_fills_the_card_at_the_chip_shapes(shape):
    """8 sequences at 160..544 tokens (W = 34 pages of 16) and at 2,208
    (W = 138): 40 x 4 blocks for smollm-360m; recurrentgemma-9b's one kv
    head takes the cluster's 16 ranks, 128 of the 132 SMs."""
    from repro_torch.kernels import flash_attention as F
    arch, W, blocks = shape
    n_kv, G, D = _decode_layouts()[arch]
    p = F.decode_plan(8, n_kv, W, 16, D, G, 2)
    assert 8 * n_kv * p.splits == blocks
    assert blocks >= 0.95 * F.DEC_SMS


@pytest.mark.parametrize("elem_bytes", [1, 2, 4])
@pytest.mark.parametrize("D", [20, 64, 128, 256])
def test_decode_plan_keeps_the_stream_partials_aligned(D, elem_bytes):
    """The streams' m and l (psw floats each) come before their acc, which
    is stored as float4: psw is nks G rounded up to 4 floats, for every G
    the entry takes (an odd G from 17 at D = 256 has one stream a head
    group, so nks G alone would leave acc 8 bytes off)."""
    from repro_torch.kernels import flash_attention as F
    text = (SRC / "csrc" / "paged_attention.cu").read_text()
    assert "ps_l = ps_m + a.psw;" in text and "ps_a = ps_l + a.psw;" in text
    for G in range(1, F.DEC_MAX_G + 1):
        for B, n_kv, W in ((1, 1, 1), (8, 1, 34), (8, 5, 138)):
            p = F.decode_plan(B, n_kv, W, 16, D, G, elem_bytes)
            assert p.stream_ml % 4 == 0
            assert p.stream_ml - 4 < p.streams * G <= p.stream_ml
            assert (2 * p.stream_ml * 4) % 16 == 0        # acc's offset
            assert 0 < p.smem <= SMEM_BLOCK


def test_decode_plan_constants_mirror_the_source():
    from repro_torch.kernels import flash_attention as F
    text = (SRC / "csrc" / "paged_attention.cu").read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (kDec\w+) = (\d+);", text)}
    assert consts == {"kDecThreads": F.DEC_THREADS, "kDecVpl": F.DEC_VPL, "kDecGh": F.DEC_GH,
                      "kDecStages": F.DEC_STAGES,
                      "kDecStageElems": F.DEC_STAGE_ELEMS,
                      "kDecMaxSplit": F.DEC_MAX_SPLIT,
                      "kDecSMs": F.DEC_SMS, "kDecMaxG": F.DEC_MAX_G}


# ---- pools, tables and the oracle ------------------------------------------
def _pools(posit, rng, P, n_kv, page, D):
    """(reference k, v, port k, v) with page 0 zero, and the port's twin
    whose page 0 holds NaR patterns (NaN for f32): the garbage page."""
    import jax.numpy as jnp
    from repro.core.array import PositArray as RefPositArray
    from repro.core.convert import f32_to_posit
    from repro.core.types import P8_2, P16_2
    ref_cfg = {"p8": P8_2, "p16": P16_2}.get(posit)
    kv = rng.standard_normal((2, P, n_kv, page, D)).astype(np.float32)
    kv[:, 0] = 0.0
    if ref_cfg is None:
        bits = [kv[0], kv[1]]
        ref = [jnp.asarray(b) for b in bits]
        bad = float("nan")
    else:
        bits = [np.array(f32_to_posit(jnp.asarray(x), ref_cfg)) for x in kv]
        ref = [RefPositArray(jnp.asarray(b), ref_cfg) for b in bits]
        bad = -(1 << (ref_cfg.n - 1))
    port = [torch.from_numpy(b.copy()) for b in bits]
    nar = [t.clone() for t in port]
    for t in nar:
        t[0] = bad
    return ref, port, nar, port_posit(ref_cfg)


def _table(rng, B, W, P, lens, page, reclaim_before=None):
    """Distinct pages 1.. for each sequence's live positions, tails at
    random pages; with reclaim_before [B], the pages wholly before it
    point at the garbage page 0."""
    table = rng.integers(0, P, (B, W)).astype(np.int32)
    perm = rng.permutation(np.arange(1, P))
    used = 0
    for b, n in enumerate(lens):
        k = min(W, -(-int(n) // page))
        table[b, :k] = perm[used:used + k]
        used += k
        if reclaim_before is not None:
            table[b, :max(0, int(reclaim_before[b])) // page] = 0
    return table


def _oracle(ref_k, ref_v, table, sl, q, n_kv, causal=True, q_offset=None,
            window=None, softcap=None):
    import jax.numpy as jnp
    from repro.serving.paged_kv import paged_attention
    qo = None if q_offset is None else np.asarray(q_offset, np.int32)
    num_new = sl - (sl - 1 if qo is None else qo)
    cache = {"k_pages": ref_k, "v_pages": ref_v,
             "page_table": jnp.asarray(table), "seq_lens": jnp.asarray(sl),
             "num_new": jnp.asarray(num_new)}
    out = paged_attention(jnp.asarray(q), cache, n_kv=n_kv, causal=causal,
                          q_offset=None if qo is None else jnp.asarray(qo),
                          window=window, softcap=softcap)
    return np.asarray(out)


# ---- a plain model of K3 ---------------------------------------------------
def _combine(parts):
    """Partials (m [G], l [G], acc [G, D]) in order -> (M, L, A): weights
    exp(m - M) of the partials that saw a key, 0 for the others."""
    ms = torch.stack([p[0] for p in parts])
    ls = torch.stack([p[1] for p in parts])
    M = torch.where(ls > 0, ms, torch.full_like(ms, NEG)).amax(0)
    M = torch.maximum(M, torch.full_like(M, NEG))
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - M), torch.zeros_like(m))
        L = L + w * l
        A = A + w[:, None] * acc
    return M, L, A


def k3_model(q, k_pages, v_pages, table, seq_lens, cfg, window=None):
    """K3's arithmetic in plain torch: the plan's splits, each streaming
    its visible keys in stages of whole pages, stage key kk to stream kk %
    nks, a stream taking its keys U at a time (one max, one rescale);
    streams combined in order, then splits in order.  Keys outside [lo,
    seq_len) and on entries outside the pool are never read."""
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import ref
    B, H, D = q.shape
    P, n_kv, page, _ = k_pages.shape
    W = table.shape[1]
    G = H // n_kv
    plan = F.decode_plan(B, n_kv, W, page, D, G, k_pages.element_size())
    nks, sp, S = plan.streams, plan.stage_pages, plan.splits
    # keys a stream takes a turn: four where the stage comes decoded (posit
    # pools above D = 128), else one
    U = 4 if k_pages.element_size() != 4 and D > 128 else 1
    kf, vf = ref.values(k_pages, cfg), ref.values(v_pages, cfg)
    scale = D ** -0.5
    out = torch.zeros(B, H, D)
    for b in range(B):
        sl = min(int(seq_lens[b]), W * page)
        lo = max(0, sl - window) if window else 0
        for h in range(n_kv):
            qh = q[b, h * G:(h + 1) * G]
            splits = []
            for s in range(S):
                pages = F.split_pages(s, S, W)
                k_lo = max(lo, pages.start * page)
                k_hi = min(sl, pages.stop * page)
                streams = [[torch.full((G,), NEG), torch.zeros(G),
                            torch.zeros(G, D)] for _ in range(nks)]

                def ok(j):
                    pg = int(table[b, j // page])
                    return k_lo <= j < k_hi and 0 <= pg < P

                if k_lo < k_hi:
                    fp, lp = k_lo // page, (k_hi - 1) // page + 1
                    for t in range(math.ceil((lp - fp) / sp)):
                        j0 = (fp + t * sp) * page
                        nk = min(sp, lp - fp - t * sp) * page
                        for ks in range(nks):
                            st = streams[ks]
                            for kA in range(ks, nk, U * nks):
                                keys = [j0 + kk
                                        for kk in range(kA, kA + U * nks, nks)
                                        if kk < nk and ok(j0 + kk)]
                                if not keys:
                                    continue
                                rows = [(int(table[b, j // page]), j % page)
                                        for j in keys]
                                sc = [(qh @ kf[pg, h, r]) * scale
                                      for pg, r in rows]
                                mx = st[0]
                                for x in sc:
                                    mx = torch.maximum(mx, x)
                                up = mx > st[0]
                                alpha = torch.exp(st[0] - mx)
                                st[1] = torch.where(up, st[1] * alpha, st[1])
                                st[2] = torch.where(up[:, None],
                                                    st[2] * alpha[:, None],
                                                    st[2])
                                st[0] = torch.where(up, mx, st[0])
                                for x, (pg, r) in zip(sc, rows):
                                    p = torch.exp(x - mx)
                                    st[1] = st[1] + p
                                    st[2] = st[2] + p[:, None] * vf[pg, h, r]
                splits.append(_combine(streams))
            _, L, A = _combine(splits)
            out[b, h * G:(h + 1) * G] = torch.where(
                L[:, None] > 0, A / torch.where(L > 0, L, 1.0)[:, None],
                torch.zeros_like(A))
    return out


K3_CASES = {
    # name: (H, n_kv, D, page, W, seq_lens, window, reclaim)
    "ragged": (6, 2, 16, 4, 12, [0, 1, 17, 40, 48], None, False),
    "page_multiples": (6, 2, 16, 4, 12, [4, 16, 32, 44, 48], None, False),
    "window": (6, 2, 16, 4, 12, [3, 9, 23, 41, 48], 10, False),
    "window_reclaimed_nar": (6, 2, 16, 4, 12, [2, 13, 30, 41, 48], 9, True),
    "all_empty": (6, 2, 16, 4, 12, [0, 0, 0, 0, 0], None, False),
    "g16_window": (16, 1, 24, 4, 16, [1, 20, 37, 64, 50], 12, True),
    "g16_d256": (16, 1, 256, 4, 8, [1, 13, 32, 27, 0], 9, True),
    "smoke_d20": (6, 2, 20, 4, 12, [5, 0, 47, 16, 33], 11, True),
}


@pytest.mark.parametrize("posit", ["float", "p8", "p16"])
@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_model_matches_the_reference(case, posit):
    H, n_kv, D, page, W, lens, window, reclaim = K3_CASES[case]
    B = len(lens)
    rng = np.random.default_rng(sum(map(ord, case)) + len(posit))
    P = B * W + 1
    (rk, rv), (tk, tv), (nk_, nv_), cfg = _pools(posit, rng, P, n_kv, page,
                                                 D)
    sl = np.asarray(lens, np.int32)
    table = _table(rng, B, W, P, sl, page,
                   sl - 1 - window if reclaim else None)
    # an entry past every sequence's length points outside the pool
    table[0, -1], table[1, -1] = -1, P + 3
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    tab_t, sl_t, q_t = (torch.from_numpy(x) for x in (table, sl, q))
    got = k3_model(q_t, nk_, nv_, tab_t, sl_t, cfg, window)
    clean = k3_model(q_t, tk, tv, tab_t, sl_t, cfg, window)
    # the garbage page (NaR / NaN) never enters the arithmetic
    assert torch.equal(got.view(torch.int32), clean.view(torch.int32))
    live = sl > 0
    assert bool((got[torch.from_numpy(~live)] == 0).all())
    if live.any():
        tbl = np.where((table >= 0) & (table < P), table, 0)
        want = _oracle(rk, rv, tbl, sl, q[:, :, None, :], n_kv,
                       window=window)[:, :, 0]
        np.testing.assert_allclose(got.numpy()[live], want[live],
                                   rtol=RTOL, atol=ATOL)


def test_k3_model_splits_are_combined_in_order():
    """A split whose keys all lie before the window, or past seq_len,
    adds nothing; a repeated model run gives the same bits."""
    from repro_torch.kernels import flash_attention as F
    rng = np.random.default_rng(3)
    H, n_kv, D, page, W = 4, 1, 8, 4, 16
    B = 2
    P = B * W + 1
    _, (tk, tv), (nk_, nv_), cfg = _pools("float", rng, P, n_kv, page, D)
    sl = np.asarray([64, 9], np.int32)
    table = _table(rng, B, W, P, sl, page, sl - 1 - 6)
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    plan = F.decode_plan(B, n_kv, W, page, D, H // n_kv, 4)
    assert plan.splits == min(F.DEC_MAX_SPLIT, W)
    a = k3_model(q, nk_, nv_, torch.from_numpy(table), torch.from_numpy(sl),
                 cfg, 6)
    b = k3_model(q, nk_, nv_, torch.from_numpy(table), torch.from_numpy(sl),
                 cfg, 6)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert bool(torch.isfinite(a).all())


def _cut_bad_pages(table, sl, page, P):
    """The table with each sequence's whole visible pages on entries
    outside [0, P) taken out (page 1 pads the end) and seq_lens shortened
    to match."""
    tbl = np.ones_like(table)
    sl_o = np.asarray(sl, np.int32).copy()
    for b, n in enumerate(sl):
        used = -(-int(n) // page)
        bad = [j for j in range(used) if not 0 <= table[b, j] < P]
        assert all((j + 1) * page <= n for j in bad)        # whole pages
        keep = [table[b, j] for j in range(used) if j not in bad]
        tbl[b, :len(keep)] = keep
        sl_o[b] -= page * len(bad)
    return tbl, sl_o


@pytest.mark.parametrize("posit", ["float", "p8", "p16"])
def test_k3_model_drops_visible_keys_on_bad_entries(posit):
    """Whole visible pages on entries -1 and P + 3 are dropped: the model
    equals the oracle over the table with those pages taken out."""
    H, n_kv, D, page, W = 6, 2, 16, 4, 12
    lens = [9, 17, 40, 0, 48]
    B = len(lens)
    rng = np.random.default_rng(len(posit) + 23)
    P = B * W + 1
    (rk, rv), (tk, tv), _, cfg = _pools(posit, rng, P, n_kv, page, D)
    sl = np.asarray(lens, np.int32)
    table = _table(rng, B, W, P, sl, page)
    table[0, 0], table[1, 2], table[2, 5], table[4, 11] = -1, P + 3, -7, P
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    got = k3_model(torch.from_numpy(q), tk, tv, torch.from_numpy(table),
                   torch.from_numpy(sl), cfg)
    tbl, sl_o = _cut_bad_pages(table, sl, page, P)
    live = sl_o > 0
    assert bool((got[torch.from_numpy(~live)] == 0).all())
    want = _oracle(rk, rv, tbl, sl_o, q[:, :, None, :], n_kv)[:, :, 0]
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=RTOL,
                               atol=ATOL)


# ---- a plain model of K4's tile walk ---------------------------------------
def k4_walk(B, H, n_kv, Sq, D, table, seq_lens, q_offset, causal, window,
            page, P):
    """K7's forward over the page table (flash_fwd_paged_kernel): for each
    block (64 folded rows i = r G + g of a kv head), its key tiles of BN
    (64 at D <= 64, else 32) from the block's lowest visible key's tile to
    its last visible key, and which keys of them it stages (below kv_hi,
    at or above the lowest visible key, on an entry inside the pool) or
    zeroes.  Yields (b, h, i0, tile span, staged keys)."""
    BM, BN = 64, 64 if D <= 64 else 32
    G = H // n_kv
    nrows = G * Sq
    W = table.shape[1]
    for b in range(B):
        kl = min(int(seq_lens[b]), W * page)
        qo = int(q_offset[b])
        for h in range(n_kv):
            for i0 in range(0, nrows, BM):
                qf = qo + i0 // G
                ql = qo + (min(i0 + BM, nrows) - 1) // G
                kv_hi = min(kl, ql + 1) if causal else kl
                kv_lo = max(0, qf - window + 1) if window else 0
                j_start = kv_lo // BN * BN
                n_t = -(-(kv_hi - j_start) // BN) if kv_hi > j_start else 0
                span = range(j_start, j_start + n_t * BN)
                staged = {j for j in span if kv_lo <= j < kv_hi
                          and 0 <= int(table[b, j // page]) < P}
                yield b, h, i0, span, staged


def _visible(j, qpos, sl, causal, window):
    return (j < sl and (not causal or j <= qpos)
            and (not window or qpos - j < window))


K4_CASES = {
    # name: (Sq, seq_lens, q_offset, causal, window, softcap, reclaim,
    #        out-of-range entries past the lengths)
    "first_chunk": (8, [8, 5, 8], [0, 0, 0], True, None, None, False, False),
    "mid_chunk": (8, [16, 13, 40], [8, 8, 32], True, None, None, False,
                  False),
    "window": (8, [16, 11, 40], [8, 3, 32], True, 6, None, False, False),
    "window_reclaimed_nar": (8, [20, 11, 44], [12, 3, 36], True, 7, None,
                             True, False),
    "bidirectional": (8, [8, 13, 24], [0, 5, 16], False, None, None, False,
                      False),
    "decode_softcap": (1, [3, 9, 24], [2, 8, 23], True, None, 2.0, False,
                       False),
    "bad_entries": (8, [16, 13, 30], [8, 5, 22], True, 5, None, True, True),
    # whole visible pages on entries outside the pool, at the decode form
    # with a softcap (serving's route to K4 at Sq = 1): dropped, as K3
    # drops them
    "bad_visible_decode": (1, [9, 17, 24], [8, 16, 23], True, None, 2.0,
                           False, "visible"),
}


@pytest.mark.parametrize("layout", [(6, 2, 16), (16, 1, 40)])
@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_tile_walk_against_brute_force_and_reference(case, layout):
    H, n_kv, D = layout
    Sq, lens, qo, causal, window, softcap, reclaim, bad = K4_CASES[case]
    B, page = len(lens), 4
    W = max(lens) // page + 2
    P = B * W + 1
    G = H // n_kv
    rng = np.random.default_rng(sum(map(ord, case)) + D)
    (rk, rv), (tk, tv), (nk_, nv_), cfg = _pools("p16", rng, P, n_kv, page,
                                                 D)
    sl, qo = np.asarray(lens, np.int32), np.asarray(qo, np.int32)
    table = _table(rng, B, W, P, sl, page,
                   qo - window if reclaim else None)
    if bad:
        table[:, -1] = -2
        table[0, 0] = P + 1                     # below any window
    if bad == "visible":
        table[1, 1] = -1
    garbage = {(b, j) for b in range(B) for j in range(W * page)
               if table[b, j // page] == 0 or not 0 <= table[b, j // page]
               < P}
    stage = {}
    for b, h, i0, span, staged in k4_walk(B, H, n_kv, Sq, D, table, sl, qo,
                                          causal, window, page, P):
        stage[b, h, i0] = staged
        for i in range(i0, min(i0 + 64, G * Sq)):
            qpos = int(qo[b]) + i // G
            for j in range(W * page):
                entry_ok = 0 <= int(table[b, j // page]) < P
                if _visible(j, qpos, int(sl[b]), causal, window) and \
                        entry_ok:
                    assert j in staged, (b, i, j)
        # staged keys are real keys: on the pool, never the garbage page
        assert not {(b, j) for j in staged} & garbage, (b, i0)
        lo = int(qo[b]) + i0 // G - window + 1 if window else 0
        assert all(lo <= j < int(sl[b]) for j in staged)

    # the walk's arithmetic: staged keys decoded, the rest zero, K7's
    # per-element mask; live rows against the oracle (over the finite
    # twin), and the NaR pool's garbage page never read
    from repro_torch.kernels import ref
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    kf, vf = ref.values(nk_, cfg), ref.values(nv_, cfg)
    out = np.zeros((B, H, Sq, D), np.float32)
    for (b, h, i0), staged in stage.items():
        for i in range(i0, min(i0 + 64, G * Sq)):
            g, r = i % G, i // G
            qpos = int(qo[b]) + r
            keys = [j for j in sorted(staged)
                    if _visible(j, qpos, int(sl[b]), causal, window)]
            if not keys:
                continue
            kk = torch.stack([kf[int(table[b, j // page]), h, j % page]
                              for j in keys])
            vv = torch.stack([vf[int(table[b, j // page]), h, j % page]
                              for j in keys])
            s = (kk @ torch.from_numpy(q[b, h * G + g, r])) * D ** -0.5
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            p = torch.softmax(s, 0)
            out[b, h * G + g, r] = (p @ vv).numpy()
    assert np.isfinite(out).all()
    if bad == "visible":
        # a decode query without a window sees every earlier key: dropping
        # a whole page is taking it out of the table
        tbl, sl_o = _cut_bad_pages(table, sl, page, P)
        want = _oracle(rk, rv, tbl, sl_o, q, n_kv, causal=causal,
                       q_offset=sl_o - 1, softcap=softcap)
    else:
        tbl = np.where((table >= 0) & (table < P), table, 0)
        want = _oracle(rk, rv, tbl, sl, q, n_kv, causal=causal, q_offset=qo,
                       window=window, softcap=softcap)
    live = np.arange(Sq)[None, :] < (sl - qo)[:, None]
    live = np.broadcast_to(live[:, None, :, None], out.shape)
    np.testing.assert_allclose(out[live], want[live], rtol=RTOL, atol=ATOL)
