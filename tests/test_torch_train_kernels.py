"""The plain versions of the port's training kernels against the JAX
reference on the CPU: the contiguous flash prefill (forward with its
log-sum-exp, and the dQ / dK dV backward) against
``repro.models.blocks._blockwise_jnp`` and its `jax.vjp`, and the
differentiable `ops.gemm` (including `posit_gemm`'s transpose_a, the dW
leg) against ``repro.kernels.ops.gemm`` under `jax.grad`.

The reference runs its jnp path (REPRO_USE_PALLAS unset): its Pallas
kernels no longer run in interpret mode under the installed JAX.  Inputs
come from numpy seeds and cross to both packages as numpy.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import port_posit  # noqa: E402

# Both sides compute in f32 and differ only in summation order and in the
# softmax's form (the reference's online softmax over 512-key chunks, the
# plain version's one pass): ~1e-6 on values of order 1.  1e-5 (abs and
# rel) leaves room for that and is far below what a wrong mask, offset or
# head mapping gives.
FWD_TOL = 1e-5
# gradients sum one more product over Sq or Skv rows: 3e-5, abs and rel
BWD_TOL = 3e-5

B, H, N_KV, D = 2, 6, 2, 16             # G = 3 query heads per kv head

# (id, Sq, Skv, q_offset [B], kv_len [B], causal, window, softcap)
CASES = [
    ("train-causal", 24, 24, (0, 0), (24, 24), True, None, None),
    ("non-causal", 10, 24, (0, 0), (24, 17), False, None, None),
    ("offset-kvlen", 8, 24, (16, 9), (24, 17), True, None, None),
    ("window", 24, 24, (0, 0), (24, 24), True, 5, None),
    ("softcap", 20, 20, (0, 0), (20, 20), True, None, 5.0),
    ("all", 9, 30, (21, 4), (30, 13), True, 7, 3.0),
]


@pytest.fixture(autouse=True)
def _jnp_reference_few_threads(monkeypatch):
    """The reference on its jnp path; torch on at most 2 threads, so that
    test workers running side by side do not oversubscribe the cores."""
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _inputs(case, kv):
    _, Sq, Skv, qo, kl, *_ = case
    rng = np.random.default_rng(Sq * 100 + Skv)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, N_KV, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, N_KV, Skv, D)).astype(np.float32)
    do = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    ref_cfg = _ref_cfg(kv)
    if ref_cfg is not None:
        import jax.numpy as jnp
        from repro.core.convert import f32_to_posit
        k = np.array(f32_to_posit(jnp.asarray(k), ref_cfg))
        v = np.array(f32_to_posit(jnp.asarray(v), ref_cfg))
    return q, k, v, do, np.array(qo, np.int32), np.array(kl, np.int32)


def _ref_cfg(kv):
    from repro.core.types import P8_2, P16_2
    return {"f32": None, "p16": P16_2, "p8": P8_2}[kv]


def _valid(case):
    """[B, Sq, Skv] mask of the keys each query row sees (numpy)."""
    _, Sq, Skv, qo, kl, causal, window, _ = case
    qpos = np.array(qo)[:, None] + np.arange(Sq)[None, :]
    kpos = np.arange(Skv)
    valid = kpos[None, None, :] < np.array(kl)[:, None, None]
    if causal:
        valid = valid & (qpos[:, :, None] >= kpos)
    if window is not None:
        valid = valid & (qpos[:, :, None] - kpos < window)
    return valid


def _reference(case, q, k, v, kv):
    import jax.numpy as jnp
    from repro.models.blocks import _blockwise_jnp
    _, Sq, Skv, qo, kl, causal, window, softcap = case

    def f(qq, kk, vv):
        return _blockwise_jnp(qq, kk, vv, n_kv=N_KV, causal=causal,
                              q_off=jnp.asarray(qo, jnp.int32),
                              window=window, q_chunk=512, kv_chunk=512,
                              softcap=softcap,
                              kv_len=jnp.asarray(kl, jnp.int32),
                              cfg_kv=_ref_cfg(kv))
    return f


def _port(case, q, k, v, kv):
    from repro_torch.core.array import PositArray
    from repro_torch.kernels import ops
    _, _, _, qo, kl, causal, window, softcap = case
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    ref_cfg = _ref_cfg(kv)
    if ref_cfg is not None:
        cfg = port_posit(ref_cfg)
        kt, vt = PositArray(kt, cfg), PositArray(vt, cfg)
    kw = dict(causal=causal, window=window, softcap=softcap)
    return kt, vt, torch.tensor(kl), torch.tensor(qo), kw


@pytest.mark.parametrize("kv", ["f32", "p16", "p8"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_prefill_plain_matches_reference(case, kv):
    """Forward out against _blockwise_jnp, lse against a float64 numpy
    logsumexp of the masked scores, on every row that sees a key; the
    counted plain version ran, no kernel."""
    import jax.numpy as jnp
    from repro.core.decode import decode_to_f32
    from repro_torch.kernels import ops
    q, k, v, _, qo, kl = _inputs(case, kv)
    want = np.asarray(_reference(case, q, k, v, kv)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    kt, vt, klt, qot, kw = _port(case, q, k, v, kv)
    ops.reset_counters()
    out, lse = ops.flash_prefill(torch.from_numpy(q), kt, vt, klt, qot,
                                 return_lse=True, **kw)
    assert ops.plain_counts()["flash_prefill"] == 1
    assert sum(ops.launch_counts().values()) == 0

    valid = _valid(case)
    live = valid.any(-1)                                   # [B, Sq]
    assert live.mean() > 0.8
    rows = np.broadcast_to(live[:, None, :], (B, H, case[1]))
    np.testing.assert_allclose(out.numpy()[rows], want[rows], rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert (out.numpy()[~rows] == 0).all() and (lse.numpy()[~rows] == 0).all()

    kf = (np.asarray(decode_to_f32(jnp.asarray(k), _ref_cfg(kv)))
          if kv != "f32" else k).astype(np.float64)
    kg = np.repeat(kf, H // N_KV, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kg) * D ** -0.5
    if case[7] is not None:
        s = np.tanh(s / case[7]) * case[7]
    s = np.where(valid[:, None], s, -np.inf)
    m = s.max(-1)
    with np.errstate(invalid="ignore"):
        want_lse = m + np.log(np.exp(s - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy()[rows], want_lse[rows],
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("kv", ["f32", "p16", "p8"])
@pytest.mark.parametrize("case", [c for c in CASES if c[0] != "all"],
                         ids=[c[0] for c in CASES if c[0] != "all"])
def test_flash_prefill_bwd_plain_matches_reference(case, kv):
    """(dQ, dK, dV) from the saved lse against jax.vjp of _blockwise_jnp;
    posit KV gives dQ only (dK = dV = None).  Every row of these cases
    sees a key (the reference averages masked values on a row that sees
    none, so its gradient there is not the kernel's)."""
    import jax
    import jax.numpy as jnp
    from repro_torch.kernels import ops
    q, k, v, do, qo, kl = _inputs(case, kv)
    assert _valid(case).any(-1).all()
    f = _reference(case, q, k, v, kv)
    kt, vt, klt, qot, kw = _port(case, q, k, v, kv)
    qt = torch.from_numpy(q)
    o, lse = ops.flash_prefill(qt, kt, vt, klt, qot, return_lse=True, **kw)
    ops.reset_counters()
    dq, dk, dv = ops.flash_prefill_bwd(qt, kt, vt, o, lse,
                                       torch.from_numpy(do), klt, qot,
                                       n_kv=N_KV, **kw)
    plain = ops.plain_counts()
    if kv == "f32":
        _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
        got = (dq, dk, dv)
        assert plain["flash_prefill_bwd_dkv"] == 1
    else:
        _, vjp = jax.vjp(lambda qq: f(qq, jnp.asarray(k), jnp.asarray(v)),
                         jnp.asarray(q))
        want = vjp(jnp.asarray(do))
        got = (dq,)
        assert dk is None and dv is None
        assert plain["flash_prefill_bwd_dkv"] == 0
    assert plain["flash_prefill_bwd_dq"] == 1
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=BWD_TOL,
                                   atol=BWD_TOL * np.abs(w).max(),
                                   err_msg=name)


def test_fused_prefill_autograd_runs_the_backward_kernels():
    """blocks.blockwise_attention differentiated by torch.autograd takes
    the forward with lse and the dQ / dK dV backward, and agrees with the
    direct flash_prefill_bwd call."""
    from repro_torch.kernels import ops
    from repro_torch.models.blocks import blockwise_attention
    case = CASES[2]
    q, k, v, do, qo, kl = _inputs(case, "f32")
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ops.reset_counters()
    out = blockwise_attention(qt, kt, vt, n_kv=N_KV, causal=True,
                              q_offset=torch.from_numpy(qo),
                              kv_len=torch.from_numpy(kl))
    out.backward(torch.from_numpy(do))
    plain = ops.plain_counts()
    assert (plain["flash_prefill"], plain["flash_prefill_bwd_dq"],
            plain["flash_prefill_bwd_dkv"]) == (1, 1, 1)
    o, lse = ops.flash_prefill(qt.detach(), kt.detach(), vt.detach(), kl, qo,
                               return_lse=True)
    want = ops.flash_prefill_bwd(qt.detach(), kt.detach(), vt.detach(), o,
                                 lse, torch.from_numpy(do), kl, qo,
                                 n_kv=N_KV)
    for g, w in zip((qt.grad, kt.grad, vt.grad), want):
        assert torch.equal(g, w)


# f32 GEMMs of K <= 48 values ~1: both sides differ by summation order
GEMM_TOL = 1e-5


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("b_kind", ["f32", "p16"])
def test_gemm_autograd_matches_reference(transpose_b, b_kind):
    """d/dA and d/dB of sum(gemm(a, b) * G) against jax.grad through
    repro.kernels.ops.gemm; a posit B carries no gradient.  The backward
    is two plain posit_gemm calls (dA with the other transpose_b, dB with
    transpose_a) besides the forward's one."""
    import jax
    import jax.numpy as jnp
    from repro.core.array import PositArray as RefPositArray
    from repro.core.convert import f32_to_posit
    from repro.core.types import P16_2
    from repro.kernels import ops as ref_ops
    from repro_torch.core.array import PositArray
    from repro_torch.kernels import ops
    rng = np.random.default_rng(11 + transpose_b)
    M, K, N = 13, 48, 20
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((N, K) if transpose_b else (K, N)
                            ).astype(np.float32)
    g = rng.standard_normal((M, N)).astype(np.float32)
    posit_b = b_kind == "p16"
    if posit_b:
        b = np.array(f32_to_posit(jnp.asarray(b), P16_2))

    def ref_loss(aa, bb):
        bop = RefPositArray(jnp.asarray(b), P16_2) if posit_b else bb
        return jnp.sum(ref_ops.gemm(aa, bop, transpose_b=transpose_b) * g)

    argn = (0,) if posit_b else (0, 1)
    want = jax.grad(ref_loss, argnums=argn)(jnp.asarray(a),
                                            jnp.asarray(b, jnp.float32))
    at = torch.from_numpy(a).requires_grad_()
    if posit_b:
        bt = PositArray(torch.from_numpy(b), port_posit(P16_2))
    else:
        bt = torch.from_numpy(b).requires_grad_()
    ops.reset_counters()
    out = ops.gemm(at, bt, transpose_b=transpose_b)
    (out * torch.from_numpy(g)).sum().backward()
    got = (at.grad,) if posit_b else (at.grad, bt.grad)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=GEMM_TOL,
                                   atol=GEMM_TOL)
    plain = ops.plain_counts()
    assert plain["posit_gemm"] == (1 if posit_b else 3)
    assert plain["pw_gemm"] == (1 if posit_b else 0)


@pytest.mark.parametrize("a_kind", ["f32", "p16", "p8"])
def test_posit_gemm_transpose_a_plain_against_numpy(a_kind):
    """posit_gemm(transpose_a=True): A stored [k, m] (f32 activations, or
    posit bits decoded exactly) contracted on its first axis, against a
    float64 numpy product of the decoded values."""
    from repro_torch.core.types import P8_2, P16_2
    from repro_torch.kernels import ref
    from repro_torch.kernels.posit_gemm import posit_gemm
    cfg = {"f32": None, "p16": P16_2, "p8": P8_2}[a_kind]
    rng = np.random.default_rng(5)
    K, M, N = 40, 17, 9
    a = torch.from_numpy(rng.standard_normal((K, M)).astype(np.float32))
    if cfg is not None:
        a = ref.encode_ref(a, cfg)
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    out = posit_gemm(a, b, cfg_a=cfg, cfg_b=None, transpose_a=True)
    af = ref.values(a, cfg).numpy().astype(np.float64)
    want = af.T @ b.numpy().astype(np.float64)
    assert out.shape == (M, N)
    np.testing.assert_allclose(out.numpy(), want, rtol=GEMM_TOL,
                               atol=GEMM_TOL)
