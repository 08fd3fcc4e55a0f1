"""The port's recurrent and hybrid serving path on the CPU (the plain
versions of K12-K14) against the JAX reference: the WKV and RG-LRU scans,
the rwkv6 and rglru serving blocks, the state-pool backends, the logits
of the rwkv6-3b and recurrentgemma-9b smoke models, the paged engine's
greedy tokens (off, p16, p8, with a preemption), chunk invariance,
sliding-window reclamation, a pure-recurrent drain past the page table,
`ops.attention`, and the serve CLI.

The reference runs its jnp path (REPRO_USE_PALLAS unset): the `*_ref`
scans of ``kernels/recurrent_scan.py`` and `flash_attention_ref`.  Weights
come from the reference's init and cross through repro_torch.convert;
inputs are made with numpy.  The reference's init sets the bonus `u` and
the decay LoRA `w_lora_b` to 0, so the scan and block tests draw them
(and logw) from a seeded normal to exercise both terms.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (CopyingJnp, numpy_tree, port_posit,  # noqa: E402
                          smoke_models)

ROOT = os.path.join(os.path.dirname(__file__), "..")

# f32 results of the same math in two frameworks: dot products of <= 64
# terms summed in other orders (einsum vs einsum, matmul vs XLA dot) differ
# by ~1e-7 relative; 1e-5 of the largest entry is far below what a wrong
# mask, shift or state would give.
F32_TOL = 1e-5
# block outputs and logits go through a few layers of such sums and
# gelu/logsigmoid, whose ulps differ between the two libraries: as
# tests/test_torch_model.py
BLOCK_TOL = 1e-4
# Under a posit policy the smoke models carry round-tripped values (state,
# token shifts, conv tails) from token to token and layer to layer.  A
# last-bit difference of the f32 math (XLA's exp or FMA contraction against
# torch's) that straddles a posit rounding boundary flips one pattern,
# which moves the value by one posit step (2^-11 relative near 1 for
# posit16 es2), and later layers carry that on.  Logits under a posit
# policy are therefore held to one posit16 step of their largest entry,
# the states of the first layer (bit-identical inputs up to those f32
# ulps) to one pattern; the scan and block tests hold each stage on its
# own inputs.
POSIT_LOGITS_TOL = 2.0 ** -11

# state modes: (name, posit format of the state, posit_state)
STATE_MODES = [("p16", "p16", True), ("p8", "p8", True),
               ("f32-rt-p16", "p16", False), ("f32", None, False)]


def _ref_cfg(name):
    from repro.core.types import P8_2, P16_2
    return {"p16": P16_2, "p8": P8_2, None: None}[name]


def _pattern_distance(a_bits, b_bits):
    """|a - b| in posit pattern order (patterns are monotone as
    two's-complement integers of the storage width)."""
    return np.abs(a_bits.astype(np.int64) - b_bits.astype(np.int64))


def _assert_state(label, got, want, cfg):
    """The port's state against the reference's: bit-equal first; where
    that fails, name the cause, count the patterns that differ and fail on
    any element more than one pattern apart.  f32 state without a format
    is held to F32_TOL."""
    got, want = np.asarray(got), np.asarray(want)
    if cfg is None:
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= F32_TOL * scale, label
        return
    if got.dtype == np.float32:           # f32 storage of posit values
        from repro.core.convert import f32_to_posit
        got = np.asarray(f32_to_posit(got, cfg))
        want = np.asarray(f32_to_posit(want, cfg))
    if np.array_equal(got, want):
        return
    dist = _pattern_distance(got, want)
    n_diff = int((dist > 0).sum())
    msg = (f"{label}: {n_diff} of {got.size} state patterns differ "
           f"(max {int(dist.max())} apart); the cause is the last-bit "
           f"difference of XLA's and torch's CPU exp or FMA contraction")
    print(msg)
    assert dist.max() <= 1, msg


def _scan_inputs(rng, B=3, H=2, T=7, dh=8):
    r, k, v = (rng.standard_normal((B, H, T, dh)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, H, T, dh)).astype(np.float32)
                   * 0.5 - 1.0)
    u = rng.standard_normal((H, dh)).astype(np.float32)
    s0 = rng.standard_normal((B, H, dh, dh)).astype(np.float32)
    return r, k, v, logw, u, s0


def _state_in(values, fmt, posit_state):
    """A seeded f32 state -> (reference operand, port operand)."""
    import jax.numpy as jnp
    from repro.core.array import PositArray as RPA
    from repro.core.convert import f32_to_posit
    from repro_torch.core.array import PositArray as TPA
    cfg = _ref_cfg(fmt)
    if posit_state:
        bits = np.asarray(f32_to_posit(jnp.asarray(values), cfg))
        return (RPA(jnp.asarray(bits), cfg),
                TPA(torch.from_numpy(bits.copy()), port_posit(cfg)))
    if cfg is not None:                   # f32 storage of posit values
        from repro.core.decode import decode_to_f32
        values = np.asarray(decode_to_f32(f32_to_posit(
            jnp.asarray(values), cfg), cfg))
    return jnp.asarray(values), torch.from_numpy(values.copy())


def _raw(x):
    return np.asarray(getattr(x, "bits", x))


@pytest.mark.parametrize("mode", STATE_MODES, ids=[m[0] for m in STATE_MODES])
def test_wkv_scan_plain_matches_reference(mode):
    """ops.wkv_scan (CPU: the plain K12) against repro's ops.wkv_scan (the
    jnp `wkv_scan_ref`), ragged num_new with a 0; the idle slot's state
    comes back bit for bit."""
    import jax.numpy as jnp
    from repro.kernels import ops as rops
    from repro_torch.kernels import ops
    name, fmt, posit_state = mode
    rng = np.random.default_rng(11)
    r, k, v, logw, u, s0 = _scan_inputs(rng)
    nn = np.array([7, 3, 0], np.int32)
    rs0, ts0 = _state_in(s0, fmt, posit_state)
    cfg = _ref_cfg(fmt)
    explicit = None if posit_state else cfg
    y, sf = rops.wkv_scan(*(jnp.asarray(a) for a in (r, k, v, logw, u)),
                          rs0, num_new=jnp.asarray(nn), cfg_state=explicit)
    ops.reset_counters()
    ty, tsf = ops.wkv_scan(*(torch.from_numpy(a) for a in (r, k, v, logw,
                                                           u)),
                           ts0, num_new=torch.from_numpy(nn),
                           cfg_state=port_posit(explicit))
    assert ops.plain_counts()["wkv_scan"] == 1
    assert hasattr(tsf, "bits") == hasattr(sf, "bits") == posit_state
    _assert_state(f"wkv {name}", _raw(tsf), _raw(sf), cfg)
    np.testing.assert_array_equal(_raw(tsf)[2], _raw(ts0)[2])
    scale = np.abs(np.asarray(y)).max()
    assert np.abs(ty.numpy() - np.asarray(y)).max() <= F32_TOL * scale
    assert not ty[1, :, 3:].any() and not ty[2].any()


@pytest.mark.parametrize("mode", STATE_MODES, ids=[m[0] for m in STATE_MODES])
def test_rglru_scan_plain_matches_reference(mode):
    import jax.numpy as jnp
    from repro.kernels import ops as rops
    from repro_torch.kernels import ops
    name, fmt, posit_state = mode
    rng = np.random.default_rng(12)
    B, T, d = 3, 9, 32
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, d))))
    a = a.astype(np.float32)
    b = rng.standard_normal((B, T, d)).astype(np.float32)
    h0 = rng.standard_normal((B, d)).astype(np.float32)
    nn = np.array([9, 4, 0], np.int32)
    rh0, th0 = _state_in(h0, fmt, posit_state)
    cfg = _ref_cfg(fmt)
    explicit = None if posit_state else cfg
    h, hf = rops.rglru_scan(jnp.asarray(a), jnp.asarray(b), rh0,
                            num_new=jnp.asarray(nn), cfg_state=explicit)
    ops.reset_counters()
    th, thf = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b), th0,
                             num_new=torch.from_numpy(nn),
                             cfg_state=port_posit(explicit))
    assert ops.plain_counts()["rglru_scan"] == 1
    _assert_state(f"rglru {name}", _raw(thf), _raw(hf), cfg)
    np.testing.assert_array_equal(_raw(thf)[2], _raw(th0)[2])
    scale = np.abs(np.asarray(h)).max()
    assert np.abs(th.numpy() - np.asarray(h)).max() <= F32_TOL * scale
    assert not th[1, 4:].any() and not th[2].any()


def _block_params(arch, seed=5):
    """One smoke layer's reference params, with u, w_lora_b drawn from a
    seeded normal (the reference's init zeroes them)."""
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.models import griffin, rwkv6
    cfg = configs.get_smoke(arch)
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    if arch == "rwkv6-3b":
        tm = rwkv6.init_rwkv6(key, cfg.d_model, cfg.rwkv_head_dim)
        tm["u"] = jnp.asarray(rng.standard_normal(tm["u"].shape)
                              .astype(np.float32))
        tm["w_lora_b"] = jnp.asarray(
            0.5 * rng.standard_normal(tm["w_lora_b"].shape)
            .astype(np.float32))
        cm = rwkv6.init_rwkv6_channel_mix(jax.random.PRNGKey(seed + 1),
                                          cfg.d_model, cfg.d_ff)
        return cfg, {"tmix": tm, "cmix": cm}
    return cfg, {"rec": griffin.init_rglru_block(key, cfg.d_model)}


def _policies(posit):
    from repro.quant.policy import PositPolicy as RP
    from repro_torch.quant.policy import PositPolicy as TP
    cfg = _ref_cfg(None if posit == "off" else posit)
    return (RP(weights=cfg, kv_cache=cfg),
            TP(weights=port_posit(cfg), kv_cache=port_posit(cfg)), cfg)


@pytest.mark.parametrize("posit", ["off", "p16", "p8"])
def test_rwkv6_blocks_match_reference(posit):
    """rwkv6_time_mix_serving and rwkv6_channel_mix_serving (float weights
    under the policy, pool-slot state, ragged num_new) against the
    reference's: outputs within BLOCK_TOL, states and shifts as the scans."""
    import jax.numpy as jnp
    from repro.models import rwkv6 as RW
    from repro_torch.models import rwkv6 as TW
    cfg, params = _block_params("rwkv6-3b")
    rpol, tpol, pcfg = _policies(posit)
    tparams = _leaf_tree(params)
    rng = np.random.default_rng(21)
    B, S, d, dh = 3, 6, cfg.d_model, cfg.rwkv_head_dim
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    nn = np.array([6, 2, 0], np.int32)
    S0 = rng.standard_normal((B, d // dh, dh, dh)).astype(np.float32) * 0.3
    last = rng.standard_normal((B, d)).astype(np.float32)
    fmt = None if posit == "off" else posit
    rS, tS = _state_in(S0, fmt, fmt is not None)
    rl, tl = _state_in(last, fmt, fmt is not None)
    out, (Sf, xl) = RW.rwkv6_time_mix_serving(
        jnp.asarray(x), params["tmix"], head_dim=dh, policy=rpol,
        state=(rS, rl), num_new=jnp.asarray(nn))
    tout, (tSf, txl) = TW.rwkv6_time_mix_serving(
        torch.from_numpy(x), tparams["tmix"], head_dim=dh, policy=tpol,
        state=(tS, tl), num_new=torch.from_numpy(nn))
    ref = np.asarray(out)
    assert np.abs(tout.numpy() - ref).max() <= BLOCK_TOL * np.abs(ref).max()
    _assert_state(f"time-mix state {posit}", _raw(tSf), _raw(Sf), pcfg)
    np.testing.assert_array_equal(txl.numpy(), np.asarray(xl))
    out, cl = RW.rwkv6_channel_mix_serving(
        jnp.asarray(x), params["cmix"], policy=rpol, last_x=rl,
        num_new=jnp.asarray(nn))
    tout, tcl = TW.rwkv6_channel_mix_serving(
        torch.from_numpy(x), tparams["cmix"], policy=tpol, last_x=tl,
        num_new=torch.from_numpy(nn))
    ref = np.asarray(out)
    assert np.abs(tout.numpy() - ref).max() <= BLOCK_TOL * np.abs(ref).max()
    np.testing.assert_array_equal(tcl.numpy(), np.asarray(cl))


def _leaf_tree(tree):
    """A reference params subtree -> torch tensors on the CPU."""
    from repro_torch.convert import _leaf, _map
    return _map(numpy_tree(tree), _leaf(torch.device("cpu")))


@pytest.mark.parametrize("posit", ["off", "p16", "p8"])
def test_rglru_block_matches_reference(posit):
    import jax.numpy as jnp
    from repro.models import griffin as RG
    from repro_torch.models import griffin as TG
    cfg, params = _block_params("recurrentgemma-9b")
    rpol, tpol, pcfg = _policies(posit)
    tparams = _leaf_tree(params)
    rng = np.random.default_rng(22)
    B, S, d = 3, 5, cfg.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    nn = np.array([5, 1, 0], np.int32)
    fmt = None if posit == "off" else posit
    rh, th = _state_in(rng.standard_normal((B, d)).astype(np.float32), fmt,
                       fmt is not None)
    rc, tc = _state_in(rng.standard_normal((B, 3, d)).astype(np.float32),
                       fmt, fmt is not None)
    out, (hf, conv) = RG.rglru_block_serving(
        jnp.asarray(x), params["rec"], policy=rpol, state=(rh, rc),
        num_new=jnp.asarray(nn))
    tout, (thf, tconv) = TG.rglru_block_serving(
        torch.from_numpy(x), tparams["rec"], policy=tpol, state=(th, tc),
        num_new=torch.from_numpy(nn))
    ref = np.asarray(out)
    assert np.abs(tout.numpy() - ref).max() <= BLOCK_TOL * np.abs(ref).max()
    _assert_state(f"rglru h {posit}", _raw(thf), _raw(hf), pcfg)
    ref = np.asarray(conv)
    assert np.abs(tconv.numpy() - ref).max() <= BLOCK_TOL * np.abs(ref).max()


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
@pytest.mark.parametrize("posit", ["off", "p16", "p8"])
def test_backends_match_reference(arch, posit):
    """zero_fresh, store_state and the layout's per-layer descriptors
    (bytes per token and per sequence), full and smoke configs."""
    import jax.numpy as jnp
    from repro import configs as RC
    from repro.serving import backends as RB
    from repro_torch import configs as TC
    from repro_torch.serving import backends as TB
    rpol, tpol, pcfg = _policies(posit)
    for get_r, get_t in ((RC.get_config, TC.get_config),
                         (RC.get_smoke, TC.get_smoke)):
        rcfg = get_r(arch, policy=rpol)
        tcfg = get_t(arch, policy=tpol)
        want = [dataclasses.astuple(x) for x in
                RB.layout_for(rcfg).descs(16)]
        got = [dataclasses.astuple(x) for x in TB.layout_for(tcfg).descs(16)]
        assert got == want
        for ctx in (1, 100, 5000):
            assert (TB.layout_for(tcfg).cache_bytes_per_seq(ctx, 16)
                    == RB.layout_for(rcfg).cache_bytes_per_seq(ctx, 16))
    rng = np.random.default_rng(4)
    vals = rng.standard_normal((4, 3, 5)).astype(np.float32)
    new = rng.standard_normal((4, 3, 5)).astype(np.float32)
    fmt = None if posit == "off" else posit
    rbuf, tbuf = _state_in(vals, fmt, fmt is not None)
    sl = np.array([0, 3, 0, 9], np.int32)
    nn = np.array([2, 0, 0, 1], np.int32)
    np.testing.assert_array_equal(
        _raw(TB.zero_fresh(tbuf, torch.from_numpy(sl))),
        _raw(RB.zero_fresh(rbuf, jnp.asarray(sl))))
    got = TB.store_state(tbuf, torch.from_numpy(new), torch.from_numpy(nn))
    want = RB.store_state(rbuf, jnp.asarray(new), jnp.asarray(nn))
    np.testing.assert_array_equal(_raw(got), _raw(want))
    np.testing.assert_array_equal(_raw(got)[1:3], _raw(tbuf)[1:3])


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
@pytest.mark.parametrize("posit", ["off", "p16", "p8"])
def test_smoke_logits_match_reference(arch, posit):
    """A ragged paged prefill and one decode step of the smoke model
    through both forwards (the reference's PTQ weights through
    convert.from_repro, scanned positions and recurrentgemma's remainder
    layers, every leaf counted by param_count): logits of every live
    position within BLOCK_TOL (posit: POSIT_LOGITS_TOL of the largest),
    and the first layer's state pool as the scans."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as RT
    from repro_torch.models import transformer as TT
    from repro_torch import tree
    cfg, params, tcfg, tparams = smoke_models(posit, arch=arch)
    assert len(tparams["layers"]) == cfg.n_layers
    assert tcfg.param_count() == sum(
        getattr(x, "bits", x).numel() for x in tree.leaves(tparams))
    fwd = jax.jit(lambda p, t, c: RT.forward(p, cfg, tokens=t, caches=c))
    B, S, page, W = 3, 12, 4, 6
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    num_new = np.array([12, 7, 0], np.int32)
    table = (1 + np.arange(B * W, dtype=np.int32)).reshape(B, W)
    zeros = np.zeros((B,), np.int32)
    pages = RT.init_paged_pages(cfg, num_pages=1 + B * W, page_size=page,
                                max_seqs=B)
    tpages = TT.init_paged_pages(tcfg, 1 + B * W, page, max_seqs=B,
                                 device="cpu")
    step = np.array([[5], [9], [0]], np.int32)
    nn2 = np.array([1, 1, 0], np.int32)
    for tk, sl, nn in ((toks, zeros, num_new), (step, num_new, nn2)):
        caches = RT.assemble_paged_caches(pages, jnp.asarray(table),
                                          jnp.asarray(sl), jnp.asarray(nn))
        ref, _, caches = fwd(params, jnp.asarray(tk), caches)
        pages = RT.extract_paged_pages(caches)
        tc = TT.assemble_paged_caches(tpages, torch.from_numpy(table),
                                      torch.from_numpy(sl),
                                      torch.from_numpy(nn))
        with torch.inference_mode():
            got, _, tc = TT.forward(tparams, tcfg,
                                    tokens=torch.from_numpy(tk), caches=tc)
        tpages = TT.extract_paged_pages(tc)
        ref = np.asarray(ref)
        pcfg = cfg.policy.kv_cache
        for b in range(B):
            n = nn[b]
            if n == 0:
                continue
            if pcfg is None:
                np.testing.assert_allclose(got[b, :n].numpy(), ref[b, :n],
                                           rtol=BLOCK_TOL, atol=BLOCK_TOL)
            else:
                err = np.abs(got[b, :n].numpy() - ref[b, :n]).max()
                assert err <= POSIT_LOGITS_TOL * np.abs(ref[b, :n]).max()
    # the first layer's state pool after both steps (reference: stacked
    # per pattern position)
    first = jax.tree_util.tree_map(lambda a: a[0], pages["scanned"][0])
    for key, leaf in tpages["layers"][0].items():
        _assert_state(f"{arch} {posit} layer 0 {key}", _raw(leaf),
                      _raw(first[key]), pcfg)


def _requests(vocab, lens=(5, 17, 9, 23, 3, 12), max_new=6, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n).astype(np.int32), max_new)
            for n in lens]


ENGINE_KW = dict(max_seqs=3, page_size=4, table_width=10, prefill_chunk=8)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
@pytest.mark.parametrize("posit", ["off", "p16", "p8"])
def test_engine_greedy_tokens_match_reference(arch, posit, monkeypatch):
    """The port's paged engine against the reference's on the smoke model,
    with a preemption: recurrentgemma's small pool preempts by itself; the
    pure-recurrent rwkv6 takes no pages, so both engines preempt the
    youngest sequence by hand at the same step.  Identical greedy
    tokens."""
    from repro.serving import engine as ref_engine
    from repro.serving.engine import PagedServingEngine as RefEngine
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import PagedServingEngine
    monkeypatch.setattr(ref_engine, "jnp", CopyingJnp())
    cfg, params, tcfg, tparams = smoke_models(posit, arch=arch)
    reqs = _requests(cfg.vocab)
    kw = dict(ENGINE_KW)
    if arch == "recurrentgemma-9b":
        kw["num_pages"] = 12
    ref = RefEngine(params, cfg, prefix_cache=False, **kw)
    ops.reset_counters()
    eng = PagedServingEngine(tparams, tcfg, device="cpu", **kw)
    for e in (ref, eng):
        for p, n in reqs:
            e.submit(p.copy(), n)
        if arch == "rwkv6-3b":
            for _ in range(4):
                e.step()
            assert e._preempt(exclude=0)
    ref_out, out = ref.run(), eng.run()
    assert ref.counters["preempted"] >= 1, "traffic did not preempt"
    assert eng.counters["preempted"] == ref.counters["preempted"]
    assert sorted(out) == sorted(ref_out) == list(range(len(reqs)))
    for rid in ref_out:
        np.testing.assert_array_equal(out[rid], ref_out[rid], err_msg=rid)
    steps = eng.counters["prefill_steps"] + eng.counters["decode_steps"]
    n_rec = sum(tcfg.kind(i) in ("rwkv6", "rglru")
                for i in range(tcfg.n_layers))
    scan = "wkv_scan" if arch == "rwkv6-3b" else "rglru_scan"
    assert ops.plain_counts()[scan] == n_rec * steps
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_chunk_invariance(arch):
    """prefill_chunk 16 against 64 in the port (p16 weights and state):
    the same greedy tokens and the same state bits in every pool."""
    from repro_torch.serving.engine import PagedServingEngine
    _, _, tcfg, tparams = smoke_models("p16", arch=arch)
    prompt = np.random.default_rng(8).integers(0, tcfg.vocab, 45) \
        .astype(np.int32)
    runs = []
    for chunk in (16, 64):
        eng = PagedServingEngine(tparams, tcfg, max_seqs=1, page_size=8,
                                 table_width=8, prefill_chunk=chunk,
                                 device="cpu")
        out = eng.run([(prompt.copy(), 6)])
        runs.append((out[0], eng.pages, eng.counters["prefill_steps"]))
    (a, pa, sa), (b, pb, sb) = runs
    assert (sa, sb) == (3, 1)
    np.testing.assert_array_equal(a, b)
    n_state = 0
    for la, lb in zip(pa["layers"], pb["layers"]):
        if "k_pages" in la:
            continue
        for key in la:
            n_state += 1
            np.testing.assert_array_equal(_raw(la[key]), _raw(lb[key]),
                                          err_msg=key)
    assert n_state > 0


def test_windowed_decode_reclaims_pages(monkeypatch):
    """The reference's tests/test_recurrent_serving.py:97-146 in the port:
    a 126-token decode against window 32, page 8 inside a 7-usable-page
    pool frees expired pages, never preempts, ends with every page free,
    and gives the reference engine's tokens."""
    import jax
    from repro.serving import engine as ref_engine
    from repro.serving.engine import PagedServingEngine as RefEngine
    from repro_torch.serving.engine import PagedServingEngine
    monkeypatch.setattr(ref_engine, "jnp", CopyingJnp())
    cfg, params, tcfg, tparams = smoke_models("p16", arch="recurrentgemma-9b")
    prompt = np.random.default_rng(2).integers(1, cfg.vocab, 6) \
        .astype(np.int32)
    kw = dict(max_seqs=2, page_size=8, table_width=32, num_pages=8,
              prefill_chunk=8)
    ref = RefEngine(params, cfg, prefix_cache=False, **kw)
    eng = PagedServingEngine(tparams, tcfg, device="cpu", **kw)
    assert eng._reclaim_window == ref._reclaim_window == cfg.window
    ref_out = ref.run([(prompt.copy(), 120)])
    out = eng.run([(prompt.copy(), 120)])
    st = eng.stats()
    assert st["expired_page_frees"] == ref.stats()["expired_page_frees"] > 0
    assert st["preempted"] == 0
    assert st["free_pages"] == 8 - 1
    np.testing.assert_array_equal(out[0], ref_out[0])
    # a pattern with a full-attention layer must not reclaim
    full = dataclasses.replace(tcfg, block_pattern=("rglru", "rglru",
                                                    "attn"))
    assert PagedServingEngine(tparams, full, device="cpu",
                              **kw)._reclaim_window is None
    del jax


def test_pure_recurrent_ignores_page_capacity(monkeypatch):
    """State-pool sequences are O(1): a 44-token request far beyond
    table_width * page_size = 16 is served, with the reference's tokens,
    and never touches the (two-page) pool."""
    from repro.serving import engine as ref_engine
    from repro.serving.engine import PagedServingEngine as RefEngine
    from repro_torch.serving.engine import PagedServingEngine
    monkeypatch.setattr(ref_engine, "jnp", CopyingJnp())
    cfg, params, tcfg, tparams = smoke_models("off", arch="rwkv6-3b")
    prompt = np.random.default_rng(3).integers(1, cfg.vocab, 40) \
        .astype(np.int32)
    kw = dict(max_seqs=2, page_size=8, table_width=2, prefill_chunk=8)
    ref_out = RefEngine(params, cfg, prefix_cache=False, **kw).run(
        [(prompt.copy(), 4)])
    eng = PagedServingEngine(tparams, tcfg, device="cpu", **kw)
    out = eng.run([(prompt.copy(), 4)])
    assert eng.num_pages == 2 and eng.stats()["free_pages"] == 1
    assert eng.outcomes[0].status == "completed"
    np.testing.assert_array_equal(out[0], ref_out[0])


@pytest.mark.parametrize("D", [16, 80, 256])
@pytest.mark.parametrize("kv", ["f32", "p16", "p8"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_reference(kv, causal, D):
    """ops.attention (CPU: the plain K14) against repro's ops.attention
    (`flash_attention_ref`) over [BH, Sq, D], queries at the last Sq of
    Skv positions, posit or f32 KV; D = 80 and 256 are head widths the
    kernel takes beyond D = 128."""
    import jax.numpy as jnp
    from repro.core.array import PositArray as RPA
    from repro.core.convert import f32_to_posit
    from repro.kernels import ops as rops
    from repro_torch.core.array import PositArray as TPA
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    BH, Sq, Skv = 6, 5, 19
    q = rng.standard_normal((BH, Sq, D)).astype(np.float32)
    k = rng.standard_normal((BH, Skv, D)).astype(np.float32)
    v = rng.standard_normal((BH, Skv, D)).astype(np.float32)
    cfg = _ref_cfg(None if kv == "f32" else kv)
    if cfg is None:
        rk, rv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    else:
        kb = np.asarray(f32_to_posit(jnp.asarray(k), cfg))
        vb = np.asarray(f32_to_posit(jnp.asarray(v), cfg))
        rk, rv = RPA(jnp.asarray(kb), cfg), RPA(jnp.asarray(vb), cfg)
        tk = TPA(torch.from_numpy(kb.copy()), port_posit(cfg))
        tv = TPA(torch.from_numpy(vb.copy()), port_posit(cfg))
    ref = np.asarray(rops.attention(jnp.asarray(q), rk, rv, causal=causal))
    ops.reset_counters()
    got = ops.attention(torch.from_numpy(q), tk, tv, causal=causal)
    assert ops.plain_counts()["flash_attention"] == 1
    assert np.abs(got.numpy() - ref).max() <= F32_TOL * np.abs(ref).max()


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_serve_cli_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
           "--smoke", "--device", "cpu", "--engine", "paged", "--batch", "2",
           "--prompt-len", "40", "--max-new", "3", "--posit", "p16",
           "--requests", "3"]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "completed=3 rejected=0 failed_nar=0" in res.stdout
    assert "state_pool" in res.stdout
