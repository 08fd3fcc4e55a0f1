"""The port's Mixture-of-Experts path on the CPU (the plain versions of
K10/K11) against the JAX reference: the grouped GEMM and its backward,
`moe_block`, the olmoe-1b-7b smoke model's logits, loss gradients and
train steps, the paged engine's greedy tokens, and both CLIs.

The reference runs its jnp path (REPRO_USE_PALLAS unset): its grouped
GEMM is `kernels/ref.py::grouped_matmul_ref` with the reference backward
of `kernels/ops.py::_grouped_mm_bwd`, and its `moe_block` takes the
one-hot oracle unless a test patches ``FORCE_GROUPED``.  Weights come
from the reference's init and cross through repro_torch.convert; inputs
are made with numpy.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import CopyingJnp, numpy_tree, port_config, \
    smoke_models  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")

# f32 results of the same math in two frameworks: sums over at most a few
# hundred products in different orders differ by ~1e-7 relative; 1e-5 of
# the largest entry is far below what a wrong group, row or mask gives
F32_TOL = 1e-5
# the smoke model's loss and gradients (as tests/test_torch_train.py)
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5

# (name, group sizes) at E = 8: routed at random, empty groups, one group
# holding every row, boundaries inside a 64-row chunk, rows past offsets[E]
LAYOUTS = {
    "random": None,
    "empty_groups": [0, 9, 0, 0, 31, 0, 0, 4],
    "one_group": [0, 0, 0, 80, 0, 0, 0, 0],
    "inside_chunk": [1, 63, 65, 3, 0, 70, 2, 33],
    "rows_past_end": [5, 0, 17, 2, 0, 0, 9, 1],
}
ROWS = {"random": 96, "empty_groups": 44, "one_group": 80,
        "inside_chunk": 240, "rows_past_end": 60}


@pytest.fixture(autouse=True)
def _jnp_reference_few_threads(monkeypatch):
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _offsets(layout: str, E: int = 8) -> np.ndarray:
    sizes = LAYOUTS[layout]
    if sizes is None:                     # each row to a random group
        rng = np.random.default_rng(1)
        keys = np.sort(rng.integers(0, E, ROWS[layout]))
        return np.searchsorted(keys, np.arange(E + 1)).astype(np.int32)
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)


def _weights(fmt: str, E: int, K: int, N: int, seed: int):
    """(port operand, port cfg, reference operand, reference cfg)."""
    import jax.numpy as jnp
    from repro.core.convert import f32_to_posit
    from repro.core.types import P8_2, P16_2
    from torch_parity import port_posit
    w = np.random.default_rng(seed).normal(
        size=(E, K, N)).astype(np.float32) * K ** -0.5
    rcfg = {"p16": P16_2, "p8": P8_2}.get(fmt)
    if rcfg is None:
        return torch.from_numpy(w), None, jnp.asarray(w), None
    bits = np.array(f32_to_posit(jnp.asarray(w), rcfg))
    return torch.from_numpy(bits), port_posit(rcfg), jnp.asarray(bits), rcfg


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("fmt", ["p16", "p8", "f32"])
@pytest.mark.parametrize("transpose_b", [False, True])
def test_grouped_gemm_plain_matches_reference(layout, fmt, transpose_b):
    """K10's plain version (through the wrapper, on CPU tensors) against
    repro's grouped_matmul_ref; transpose_b against the reference on the
    transposed storage.  Rows outside every group are exactly 0."""
    import jax.numpy as jnp
    from repro.kernels.ref import grouped_matmul_ref
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.kernels import ops
    E, K, N = 8, 48, 40
    off = _offsets(layout)
    S = ROWS[layout]
    w, cfg, rw, rcfg = _weights(fmt, E, K, N, seed=2)
    x = np.random.default_rng(3).normal(
        size=(S, N if transpose_b else K)).astype(np.float32)
    ops.reset_counters()
    got = GG.posit_grouped_gemm(torch.from_numpy(x), w,
                                torch.from_numpy(off), cfg,
                                transpose_b=transpose_b).numpy()
    assert ops.plain_counts()["grouped_gemm"] == 1
    assert sum(ops.launch_counts().values()) == 0
    rwt = jnp.swapaxes(rw, 1, 2) if transpose_b else rw
    want = np.asarray(grouped_matmul_ref(jnp.asarray(x), rwt,
                                         jnp.asarray(off), cfg_b=rcfg))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_TOL * np.abs(want).max())
    outside = np.ones(S, bool)
    outside[off[0]:off[-1]] = False
    assert (got[outside] == 0).all() and (want[outside] == 0).all()


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("fmt", ["f32", "p16", "p8"])
def test_grouped_matmul_grads_match_reference(layout, fmt):
    """`ops.grouped_matmul`'s autograd (`_GroupedMM`: dX through K10's
    transpose_b plain version, dW through K11's) against jax.grad through
    repro.kernels.ops.grouped_matmul, whose jnp backward is the reference
    leg; posit weights get no gradient, and the cotangent of rows outside
    every group is masked."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as rops
    from repro_torch.kernels import ops
    E, K, N = 8, 48, 40
    off = _offsets(layout)
    S = ROWS[layout]
    w, cfg, rw, rcfg = _weights(fmt, E, K, N, seed=4)
    x = np.random.default_rng(5).normal(size=(S, K)).astype(np.float32)

    def rloss(x, w):
        out = rops.grouped_matmul(x, w, jnp.asarray(off), cfg=rcfg)
        return (out * jnp.sin(out)).sum()

    argnums = (0,) if rcfg is not None else (0, 1)
    rgrads = jax.grad(rloss, argnums=argnums)(jnp.asarray(x), rw)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = w.requires_grad_(True) if cfg is None else w
    ops.reset_counters()
    out = ops.grouped_matmul(tx, tw, torch.from_numpy(off), cfg=cfg)
    (out * torch.sin(out)).sum().backward()
    plain = ops.plain_counts()
    assert plain["grouped_gemm"] == 2                # forward + dX
    assert plain["grouped_gemm_dw"] == (1 if cfg is None else 0)
    for got, want in zip((tx.grad, tw.grad if cfg is None else None),
                         rgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=F32_TOL * np.abs(want).max())
    if cfg is not None:
        assert tw.grad is None


def test_grouped_dw_plain_empty_groups_and_raw_ints():
    """K11's plain version gives exactly 0 for empty groups and ignores the
    rows past offsets[E]; raw ints without a cfg are refused."""
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.kernels import ops
    off = torch.from_numpy(_offsets("rows_past_end"))
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(60, 12)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(60, 7)).astype(np.float32))
    dw = GG.posit_grouped_gemm_dw(x, g, off)
    assert dw.shape == (8, 12, 7)
    for e, n in enumerate(LAYOUTS["rows_past_end"]):
        a = int(off[e])
        want = x[a:a + n].T @ g[a:a + n]
        assert torch.equal(dw[e], want) if n else bool((dw[e] == 0).all())
    with pytest.raises(TypeError, match="format"):
        ops.grouped_matmul(x, torch.zeros((8, 12, 7), dtype=torch.int16),
                           off)


def _moe_params(E, d, ff, act, seed):
    import jax
    from repro.models import moe as RM
    from repro_torch.convert import _leaf
    p = RM.init_moe(jax.random.PRNGKey(seed), d, ff, E, act)
    to = _leaf(torch.device("cpu"))
    return p, {k: to(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("force_grouped", [False, True],
                         ids=["ref_oneshot", "ref_grouped"])
@pytest.mark.parametrize("capacity", [1.25, 0.5, None])
@pytest.mark.parametrize("posit", ["off", "p16"])
def test_moe_block_matches_reference(force_grouped, capacity, posit,
                                     monkeypatch):
    """The port's moe_block (grouped dispatch) against repro's, on its
    one-hot oracle and on its grouped path (FORCE_GROUPED patched in the
    test), with capacity drops (1.25, 0.5) and without (None); float
    weights under the posit16 policy take the STE round trip on both
    sides."""
    import jax.numpy as jnp
    from repro.core.types import P16_2
    from repro.models import moe as RM
    from repro.quant.policy import PositPolicy as RPolicy
    from repro_torch.core.types import P16_2 as TP16
    from repro_torch.models import moe as TM
    from repro_torch.quant.policy import PositPolicy
    monkeypatch.setattr(RM, "FORCE_GROUPED", force_grouped)
    E, k, d, ff = 8, 2, 64, 96
    rp, tp = _moe_params(E, d, ff, "swiglu", seed=1)
    x = np.random.default_rng(2).normal(size=(2, 64, d)).astype(np.float32)
    rpol = RPolicy(weights=P16_2) if posit == "p16" else RPolicy()
    tpol = PositPolicy(weights=TP16) if posit == "p16" else PositPolicy()
    kw = dict(n_experts=E, top_k=k, act="swiglu", capacity_factor=capacity,
              group_size=64)
    want, waux = RM.moe_block(jnp.asarray(x), rp, policy=rpol, **kw)
    got, aux = TM.moe_block(torch.from_numpy(x), tp, policy=tpol, **kw)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F32_TOL * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    if capacity == 0.5:                   # the drops really happened
        xt = torch.from_numpy(x).reshape(2, 64, d)
        *_, keep, _ = TM._route(xt, tp, n_experts=E, top_k=k, cap=8,
                                policy=tpol)
        assert not bool(keep.all())


@pytest.mark.parametrize("grouped", [False, True],
                         ids=["ref_oneshot", "ref_grouped"])
def test_forced_drop_renormalizes_over_kept_experts(grouped, monkeypatch):
    """tests/test_moe_grouped.py's forced-drop case (cap = 1): a token whose
    sibling expert dropped puts its whole weight on the kept expert, in
    the port as in the reference on both of its paths."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as RM
    from repro.quant.policy import NONE
    from repro_torch.models import moe as TM
    from repro_torch.quant.policy import PositPolicy
    monkeypatch.setattr(RM, "FORCE_GROUPED", grouped)
    E, k, d, ff = 4, 2, 16, 24
    rp, tp = _moe_params(E, d, ff, "gelu", seed=4)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (1, 8, d)))
    kw = dict(n_experts=E, top_k=k, act="gelu", capacity_factor=0.25,
              group_size=8)
    want, _ = RM.moe_block(jnp.asarray(x), rp, policy=NONE, **kw)
    got, _ = TM.moe_block(torch.from_numpy(x), tp, policy=PositPolicy(),
                          **kw)
    *_, keep, comb_w = TM._route(torch.from_numpy(x), tp, n_experts=E,
                                 top_k=k, cap=1, policy=PositPolicy())
    partial = keep.sum(-1) == 1
    assert bool(partial.any()), "no partial drop; the case is vacuous"
    assert torch.allclose(comb_w.sum(-1)[partial], torch.ones(1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("posit", ["off", "p16"])
@pytest.mark.parametrize("capacity", [1.25, None])
def test_grouped_dispatch_matches_own_oneshot(posit, capacity):
    """The port's grouped path against its own one-hot oracle, with posit16
    storage (PositArray experts from PTQ) or float weights, with and
    without drops."""
    from repro_torch.core.types import P16_2
    from repro_torch.models import moe as TM
    from repro_torch.models.blocks import _normal
    from repro_torch.quant.policy import PositPolicy
    from repro_torch.quant.ptq import quantize_for_serving
    gen = torch.Generator().manual_seed(3)
    E, k, d, ff = 8, 2, 64, 96
    p = {"moe": TM.init_moe(gen, d, ff, E, "swiglu")}
    pol = PositPolicy()
    if posit == "p16":
        p = quantize_for_serving(p, P16_2)
        pol = PositPolicy(weights=P16_2)
        assert not isinstance(p["moe"]["router"], type(p["moe"]["w_up"]))
    p = p["moe"]
    x = _normal(gen, (4, 32, d), 1.0)
    gs = 64
    cap = gs if capacity is None else int(capacity * gs * k / E)
    xt = x.reshape(2, gs, d)
    _, gate_idx, _, pos, keep, comb_w = TM._route(
        xt, p, n_experts=E, top_k=k, cap=cap, policy=pol)
    kw = dict(n_experts=E, top_k=k, act="swiglu", policy=pol,
              gate_idx=gate_idx, comb_w=comb_w)
    got = TM._dispatch_grouped(xt, p, **kw)
    want = TM._dispatch_oneshot(xt, p, cap=cap, pos=pos, keep=keep, **kw)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=F32_TOL * float(want.abs().max()))


def test_ptq_quantizes_experts_and_keeps_router_f32():
    """PTQ leaf selection as repro/quant/ptq.py: moe/w_(up|gate|down)
    become posit storage, moe/router stays f32; convert.from_repro
    unstacks the moe subtree of the reference's scanned params."""
    from repro_torch.core.array import PositArray
    _, rparams, tcfg, tp = smoke_models("p16", arch="olmoe-1b-7b")
    assert len(tp["layers"]) == tcfg.n_layers == 2
    for i, layer in enumerate(tp["layers"]):
        moe = layer["moe"]
        for name in ("w_up", "w_gate", "w_down"):
            assert isinstance(moe[name], PositArray)
            want = np.asarray(rparams["scanned"][0]["moe"][name].bits)[i]
            np.testing.assert_array_equal(moe[name].bits.numpy(), want)
        assert isinstance(moe["router"], torch.Tensor)
        assert moe["router"].dtype == torch.float32
        assert "mlp" not in layer
    assert tcfg.param_count() == sum(
        (x.bits if isinstance(x, PositArray) else x).numel()
        for x in _leaves(tp))


def _leaves(tree):
    from repro_torch import tree as T
    return T.leaves(tree)


@pytest.mark.parametrize("posit", ["off", "p16", "p8"])
def test_model_logits_and_aux_match_reference(posit):
    """Full olmoe smoke-model logits and aux loss (forward without caches:
    capacity 1.25) from the reference's PTQ'd params through
    convert.from_repro."""
    import jax.numpy as jnp
    from repro.models.transformer import forward as rforward
    from repro_torch.models.transformer import forward
    cfg, params, tcfg, tparams = smoke_models(posit, arch="olmoe-1b-7b")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 64)).astype(
        np.int32)
    want, waux, _ = rforward(params, cfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, aux, _ = forward(tparams, tcfg, tokens=torch.from_numpy(toks))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    assert float(aux) > 0


def _ref_float_models(posit: str):
    import jax
    from repro import configs
    from repro.core.types import P8_2, P16_2
    from repro.models.transformer import init_params
    from repro.quant.policy import PositPolicy
    from repro_torch.convert import from_repro
    pc = {"p8": P8_2, "p16": P16_2}.get(posit)
    cfg = configs.get_smoke("olmoe-1b-7b", policy=PositPolicy(weights=pc))
    params = init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, port_config(cfg), from_repro(numpy_tree(params),
                                                     device="cpu")


def _ref_batch(step: int, vocab: int):
    from repro.data.pipeline import DataConfig, global_batch_at
    b = global_batch_at(step, DataConfig(vocab=vocab, seq_len=32,
                                         global_batch=4))
    return b, {"tokens": torch.from_numpy(np.array(b["tokens"]))}


def _assert_trees_close(got, want, tol, what):
    from repro_torch import tree
    g, w = tree.leaves(got), tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        scale = float(b.abs().max()) or 1.0
        err = float((a - b).abs().max())
        assert err <= tol * scale, f"{what} leaf {i}: {err} > {tol}*{scale}"


@pytest.mark.parametrize("posit", ["off", "p16", "p8"])
def test_lm_loss_and_grads_match_reference(posit):
    """lm_loss (NLL + 0.01 aux over 4 x 32 tokens: one routing group of
    128 with capacity drops) and every gradient leaf, router and experts
    included, against jax.value_and_grad of the reference's lm_loss; then
    the structure of the path: per layer, 3 grouped GEMMs forward, 3 more
    in the recompute, 3 dX and 3 dW."""
    import jax
    from repro.training import train_step as RT
    from repro_torch.convert import from_repro
    from repro_torch.kernels import ops
    from repro_torch.training import train_step as TT
    cfg, params, tcfg, tparams = _ref_float_models(posit)
    batch, tbatch = _ref_batch(0, cfg.vocab)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: RT.lm_loss(p, cfg, batch), has_aux=True))(params)
    ops.reset_counters()
    tloss, _, tgrads = TT._compute_grads(tparams, tbatch, tcfg, 1)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=LOSS_RTOL)
    _assert_trees_close(tgrads, from_repro(numpy_tree(grads), device="cpu"),
                        GRAD_TOL, "grad")
    plain = ops.plain_counts()
    L = tcfg.n_layers
    assert plain["grouped_gemm"] == 9 * L and plain["grouped_gemm_dw"] == 3 * L
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.parametrize("posit", ["off", "p16"])
def test_train_steps_match_reference(posit):
    """Three train steps of the olmoe smoke model from the same weights on
    the reference's batches: losses step by step, params after (held as
    tests/test_torch_train.py holds the dense model's)."""
    from repro.optim.adamw import OptConfig as ROpt
    from repro.optim.adamw import init_state as ref_init
    from repro.training.train_step import make_train_step as ref_make
    from repro_torch import tree
    from repro_torch.convert import from_repro
    from repro_torch.optim.adamw import OptConfig, init_state
    from repro_torch.training.train_step import make_train_step
    cfg, params, tcfg, tparams = _ref_float_models(posit)
    kw = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    ref_step = ref_make(cfg, ROpt(**kw), donate=False)
    step = make_train_step(tcfg, OptConfig(**kw), device="cpu")
    state, tstate = ref_init(params, ROpt(**kw)), init_state(tparams,
                                                             OptConfig(**kw))
    for s in range(3):
        batch, tbatch = _ref_batch(s, cfg.vocab)
        params, state, m = ref_step(params, state, batch)
        tparams, tstate, tm = step(tparams, tstate, tbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                                   rtol=LOSS_RTOL)
    want = tree.leaves(from_repro(numpy_tree(params), device="cpu"))
    got = tree.leaves(tparams)
    far = 0
    for a, b in zip(got, want):
        diff = (a - b).abs()
        assert float(diff.max()) <= 2 * kw["lr_peak"]
        far += int((diff > 1e-5 * (1 + b.abs())).sum())
    assert far <= 1e-4 * sum(x.numel() for x in want), far


def test_train_step_is_deterministic():
    """The same step from the same state twice: bit-identical params and
    optimizer state (the combine is a fixed-order sum, not a scatter-add)."""
    from repro_torch import configs, tree
    from repro_torch.core.types import P16_2
    from repro_torch.data.pipeline import DataConfig, global_batch_at
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import OptConfig, init_state
    from repro_torch.quant.policy import PositPolicy
    from repro_torch.training.train_step import make_train_step
    cfg = configs.get_smoke("olmoe-1b-7b", policy=PositPolicy(weights=P16_2))
    opt = OptConfig(lr_peak=1e-3, warmup_steps=1, total_steps=4)
    batch = global_batch_at(0, DataConfig(vocab=cfg.vocab, seq_len=32,
                                          global_batch=4), device="cpu")
    step = make_train_step(cfg, opt, device="cpu")
    outs = []
    for _ in range(2):
        params = init_params(cfg, seed=0, device="cpu")
        outs.append(step(params, init_state(params, opt), batch)[:2])
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(outs[0]),
                                                 tree.leaves(outs[1])))


ENGINE_KW = dict(max_seqs=3, page_size=8, table_width=4, num_pages=7,
                 prefill_chunk=8)


def _requests(vocab: int):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, vocab, n).astype(np.int32), 8)
            for n in (5, 17, 9, 23, 3, 12)]


@pytest.mark.parametrize("posit", ["off", "p16", "p8"])
def test_engine_greedy_tokens_match_reference(posit, monkeypatch):
    """The port's paged engine serving the olmoe smoke model (posit weights
    and KV from the reference's PTQ) against the reference's engine, with
    preemption: identical greedy tokens."""
    from repro.serving import engine as ref_engine
    from repro.serving.engine import PagedServingEngine as RefEngine
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import PagedServingEngine
    monkeypatch.setattr(ref_engine, "jnp", CopyingJnp())
    cfg, params, tcfg, tparams = smoke_models(posit, arch="olmoe-1b-7b")
    reqs = _requests(cfg.vocab)
    ref = RefEngine(params, cfg, prefix_cache=False, **ENGINE_KW)
    ref_out = ref.run([(p.copy(), n) for p, n in reqs])
    ops.reset_counters()
    eng = PagedServingEngine(tparams, tcfg, device="cpu", **ENGINE_KW)
    out = eng.run([(p.copy(), n) for p, n in reqs])
    assert ref.counters["preempted"] >= 1, "traffic did not preempt"
    assert eng.counters["preempted"] == ref.counters["preempted"]
    assert sorted(out) == sorted(ref_out) == list(range(len(reqs)))
    for rid in ref_out:
        np.testing.assert_array_equal(out[rid], ref_out[rid], err_msg=rid)
    steps = eng.counters["prefill_steps"] + eng.counters["decode_steps"]
    assert ops.plain_counts()["grouped_gemm"] == 3 * tcfg.n_layers * steps
    assert ops.plain_counts()["grouped_gemm_dw"] == 0


def test_serving_output_independent_of_batch_composition():
    """Serving never drops and combines in a fixed order, so a request's
    tokens do not depend on which other requests share its steps."""
    from repro_torch.serving.engine import PagedServingEngine
    _, _, tcfg, tparams = smoke_models("p16", arch="olmoe-1b-7b")
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, tcfg.vocab, 7).astype(np.int32)
    others = [(rng.integers(0, tcfg.vocab, int(rng.integers(3, 10))
                            ).astype(np.int32), 5) for _ in range(3)]
    kw = dict(max_seqs=4, page_size=4, table_width=8, prefill_chunk=8,
              device="cpu")
    solo = PagedServingEngine(tparams, tcfg, **kw).run([(prompt.copy(), 5)])
    crowd = PagedServingEngine(tparams, tcfg, **kw).run(
        [(prompt.copy(), 5)] + others)
    np.testing.assert_array_equal(solo[0], crowd[0])


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_clis_run_olmoe_smoke_on_cpu(cli):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    base = [sys.executable, "-m", f"repro_torch.launch.{cli}", "--arch",
            "olmoe-1b-7b", "--smoke", "--device", "cpu"]
    if cli == "serve":
        cmd = base + ["--engine", "paged", "--batch", "2", "--prompt-len",
                      "12", "--max-new", "3", "--posit", "p16",
                      "--requests", "3"]
    else:
        cmd = base + ["--steps", "2", "--seq-len", "64", "--global-batch",
                      "4"]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    if cli == "serve":
        assert "completed=3 rejected=0 failed_nar=0" in res.stdout
        assert "'grouped_gemm'" in res.stdout
    else:
        assert "olmoe-1b-7b-smoke" in res.stdout and "final loss" in res.stdout
