"""The port's training path on the CPU (the plain versions of every
kernel): `lm_loss` and its gradients, the AdamW update and the train step
against the JAX reference's on the same weights and batches, and the
data pipeline, checkpoints, trainer and CLI against the reference's own
contracts (``tests/test_training_infra.py``).

The reference runs its jnp path (REPRO_USE_PALLAS unset).  Weights come
from the reference's init_params and cross through repro_torch.convert;
gradients and AdamW moments have the params' structure and cross the
same way.
"""
from __future__ import annotations

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import numpy_tree, port_config  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")

# f32 loss of the 4-layer smoke model: the two frameworks sum GEMMs and
# attention in different orders (~1e-7 relative per op); 1e-5 relative on
# the loss and 2e-5 of each gradient leaf's largest entry leave room for
# the growth of those differences through the layers and are far below
# what a wrong mask, rotation, cast or chain rule gives.
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5


@pytest.fixture(autouse=True)
def _jnp_reference_few_threads(monkeypatch):
    """The reference on its jnp path; torch on at most 2 threads, so that
    test workers running side by side do not oversubscribe the cores."""
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _ref_models(posit: str):
    """(reference cfg, reference float params, port cfg, port params)."""
    import jax
    from repro import configs
    from repro.core.types import P8_2, P16_2
    from repro.models.transformer import init_params
    from repro.quant.policy import PositPolicy
    from repro_torch.convert import from_repro
    pc = {"p8": P8_2, "p16": P16_2}.get(posit)
    cfg = configs.get_smoke("smollm-360m", policy=PositPolicy(weights=pc))
    params = init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, port_config(cfg), from_repro(numpy_tree(params),
                                                     device="cpu")


def _ref_batch(step: int, vocab: int, seq_len: int = 24, rows: int = 4):
    from repro.data.pipeline import DataConfig, global_batch_at
    b = global_batch_at(step, DataConfig(vocab=vocab, seq_len=seq_len,
                                         global_batch=rows))
    return b, {"tokens": torch.from_numpy(np.array(b["tokens"]))}


def _port_tree(ref_tree):
    from repro_torch.convert import from_repro
    return from_repro(numpy_tree(ref_tree), device="cpu")


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
    """lm_loss and every gradient leaf against jax.value_and_grad of the
    reference's lm_loss; float weights under the posit policy go through
    the straight-through cast on both sides."""
    import jax
    from repro.training import train_step as RT
    from repro_torch.kernels import ops
    from repro_torch.training import train_step as TT
    cfg, params, tcfg, tparams = _ref_models(posit)
    batch, tbatch = _ref_batch(0, cfg.vocab)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: RT.lm_loss(p, cfg, batch), has_aux=True))(params)
    ops.reset_counters()
    tloss, metrics, tgrads = TT._compute_grads(tparams, tbatch, tcfg, 1)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=LOSS_RTOL)
    _assert_trees_close(tgrads, _port_tree(grads), GRAD_TOL, "grad")
    plain = ops.plain_counts()
    L = tcfg.n_layers
    # remat: each layer's attention runs forward twice, backward once
    assert plain["flash_prefill"] == 2 * L
    assert plain["flash_prefill_bwd_dq"] == plain["flash_prefill_bwd_dkv"] == L
    # 7 GEMMs per layer + the LM head, forward + recompute + dA + dB
    assert plain["posit_gemm"] == 4 * (7 * L + 1)
    assert sum(ops.launch_counts().values()) == 0


def test_adamw_update_and_nar_skip_match_reference():
    """One AdamW update (clipping, bias correction, decay) on the port's
    tree against the reference's update on its stacked tree, with the
    port's decay mask (every per-layer leaf, as the reference's stacked
    ndim >= 2 rule decays them); then a NaN gradient skips the update,
    keeps params and moments, and counts one nar_skip, on both sides."""
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw as RA
    from repro_torch import tree
    from repro_torch.models.transformer import decay_mask
    from repro_torch.optim import adamw as TA
    cfg, params, tcfg, tparams = _ref_models("off")
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * 0.05), params)
    ocfg = RA.OptConfig(lr_peak=1e-3, warmup_steps=3, total_steps=20)
    tocfg = TA.OptConfig(lr_peak=1e-3, warmup_steps=3, total_steps=20)
    state = RA.init_state(params, ocfg)
    tstate = TA.init_state(tparams, tocfg)
    mask = decay_mask(tparams)
    assert mask["layers"][0]["ln1"]["scale"] and not mask["ln_f"]["scale"]
    p1, s1, m1 = RA.apply_updates(params, grads, state, ocfg)
    tp1, ts1, tm1 = TA.apply_updates(tparams, _port_tree(grads), tstate,
                                     tocfg, decay=mask)
    # the same f32 formulas leaf by leaf: only the global norm's summation
    # order differs, which moves the clip scale by an ulp or two
    _assert_trees_close(tp1, _port_tree(p1), 1e-6, "params")
    _assert_trees_close(ts1["m"], _port_tree(s1["m"]), 1e-6, "m")
    _assert_trees_close(ts1["v"], _port_tree(s1["v"]), 1e-6, "v")
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm1[k]), float(m1[k]), rtol=1e-6)
    assert int(ts1["step"]) == int(s1["step"]) == 1

    bad = jax.tree.map(lambda g: g.at[(0,) * g.ndim].set(jnp.nan), grads)
    p2, s2, m2 = RA.apply_updates(p1, bad, s1, ocfg)
    tp2, ts2, tm2 = TA.apply_updates(tp1, _port_tree(bad), ts1, tocfg,
                                     decay=mask)
    assert int(m2["nar_skips"]) == int(tm2["nar_skips"]) == 1
    assert int(ts2["step"]) == int(s2["step"]) == 1
    for a, b in zip(tree.leaves(tp2), tree.leaves(tp1)):
        assert torch.equal(a, b)
    for a, b in zip(tree.leaves(ts2["m"]), tree.leaves(ts1["m"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("posit", ["off", "p16"])
def test_train_steps_match_reference(posit):
    """Three train steps from the same weights on the reference's own
    batches: the losses agree step by step and the params after them.
    Adam moves each weight by ~lr per step whatever its gradient's size,
    so where a gradient is at the noise level the two sides may move it
    differently: the params are held within 2 * lr of each other, and
    to 1e-5 relative on all but a few entries."""
    import jax
    from repro.optim.adamw import OptConfig as ROpt
    from repro.training.train_step import make_train_step as ref_make
    from repro_torch import tree
    from repro_torch.optim.adamw import OptConfig, init_state
    from repro_torch.training.train_step import make_train_step
    cfg, params, tcfg, tparams = _ref_models(posit)
    kw = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    ref_step = ref_make(cfg, ROpt(**kw), donate=False)
    step = make_train_step(tcfg, OptConfig(**kw), device="cpu")
    from repro.optim.adamw import init_state as ref_init
    state, tstate = ref_init(params, ROpt(**kw)), init_state(tparams,
                                                             OptConfig(**kw))
    for s in range(3):
        batch, tbatch = _ref_batch(s, cfg.vocab)
        params, state, m = ref_step(params, state, batch)
        tparams, tstate, tm = step(tparams, tstate, tbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(m["grad_norm"]), rtol=1e-4)
    want = tree.leaves(_port_tree(params))
    got = tree.leaves(tparams)
    far = 0
    for a, b in zip(got, want):
        diff = (a - b).abs()
        assert float(diff.max()) <= 2 * kw["lr_peak"]
        far += int((diff > 1e-5 * (1 + b.abs())).sum())
    assert far <= 1e-4 * sum(x.numel() for x in want), far


def test_accum_steps_matches_single_batch():
    """accum_steps=2 averages two half-batch gradients: equal to one step
    on the whole batch within f32 summation order."""
    from repro_torch.training.train_step import _compute_grads
    _, _, tcfg, tparams = _ref_models("p16")
    _, tbatch = _ref_batch(1, tcfg.vocab)
    l1, _, g1 = _compute_grads(tparams, tbatch, tcfg, 1)
    l2, _, g2 = _compute_grads(tparams, tbatch, tcfg, 2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=LOSS_RTOL)
    _assert_trees_close(g2, g1, GRAD_TOL, "accumulated grad")


def test_data_pipeline_deterministic_seekable_and_tiled():
    from repro_torch.data.pipeline import (DataConfig, global_batch_at,
                                           host_batch_at, host_row_bounds)
    cfg = DataConfig(vocab=100, seq_len=32, global_batch=7, seed=7)
    b1 = global_batch_at(5, cfg, device="cpu")["tokens"]
    assert b1.shape == (7, 33) and b1.dtype == torch.int32
    assert int(b1.min()) >= 0 and int(b1.max()) < 100
    assert torch.equal(b1, global_batch_at(5, cfg, device="cpu")["tokens"])
    assert not torch.equal(b1, global_batch_at(6, cfg, device="cpu")["tokens"])
    other_seed = DataConfig(vocab=100, seq_len=32, global_batch=7, seed=8)
    assert not torch.equal(b1, global_batch_at(5, other_seed,
                                               device="cpu")["tokens"])
    for nh in (1, 2, 3, 4, 7):
        parts = [host_batch_at(5, cfg, h, nh, device="cpu")["tokens"]
                 for h in range(nh)]
        assert torch.equal(torch.cat(parts), b1)
        bounds = [host_row_bounds(7, h, nh) for h in range(nh)]
        assert bounds[0][0] == 0 and bounds[-1][1] == 7
    with pytest.raises(ValueError):
        host_row_bounds(7, 3, 3)
    # the affine recurrence shows through the noise: most tokens follow it
    x = b1.long()
    hits = 0
    for r in range(7):
        for t in range(1, 31):
            a_b = [(a, (int(x[r, t]) - a * int(x[r, t - 1])) % 100)
                   for a in range(1, 64)]
            nxt = {(a * int(x[r, t]) + b) % 100 for a, b in a_b}
            hits += int(x[r, t + 1]) in nxt
    assert hits > 0.8 * 7 * 30


# the reference's training-infra model (tests/test_training_infra.py)
def _tiny():
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.transformer import ModelConfig
    from repro_torch.optim.adamw import OptConfig
    return (ModelConfig("tiny", n_layers=2, d_model=64, n_heads=4, n_kv=2,
                        d_ff=128, vocab=128),
            OptConfig(lr_peak=1e-3, warmup_steps=5, total_steps=40),
            DataConfig(vocab=128, seq_len=64, global_batch=8))


def _run(steps, ckpt_dir=None, every=50):
    from repro_torch.training.trainer import RestartPolicy, train_loop
    cfg, opt, data = _tiny()
    return train_loop(cfg, opt, data, steps, ckpt_dir=ckpt_dir,
                      policy=RestartPolicy(ckpt_every=every), verbose=False,
                      device="cpu")


def _equal(a, b):
    from repro_torch import tree
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a),
                                                 tree.leaves(b)))


def test_loss_decreases():
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.training.trainer import train_loop
    cfg, _, _ = _tiny()
    _, _, hist = train_loop(cfg, OptConfig(lr_peak=3e-3, warmup_steps=10,
                                           total_steps=60),
                            DataConfig(vocab=128, seq_len=64,
                                       global_batch=16), 60, log_every=5,
                            verbose=False, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5
    # on the CPU every logged interval ran the GEMMs' plain version
    assert all(h["plain_calls"].get("posit_gemm", 0) > 0 for h in hist)


def test_restart_bit_identical(tmp_path):
    td = str(tmp_path)
    p1, o1, _ = _run(12, td, every=5)
    p2, o2, hist = _run(12, td)          # resumes from the final checkpoint
    assert hist == []
    assert _equal(p1, p2) and _equal(o1, o2)


def test_crash_resume_equals_uninterrupted(tmp_path):
    """A run stopped at step 10 and resumed to 12 ends bit for bit where
    the uninterrupted 12-step run does, optimizer state included."""
    td = str(tmp_path)
    p_full, o_full, _ = _run(12)
    _run(10, td, every=5)
    p_res, o_res, _ = _run(12, td)
    assert _equal(p_full, p_res) and _equal(o_full, o_res)


def test_corrupted_checkpoint_falls_back(tmp_path):
    from repro_torch.checkpoint import store
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import init_state
    td = str(tmp_path)
    _run(12, td, every=5)
    steps = sorted(glob.glob(os.path.join(td, "step_*")))
    assert [os.path.basename(s) for s in steps] == [
        "step_00000005", "step_00000010", "step_00000012"]
    os.remove(os.path.join(steps[-1], "leaf_00000.npy"))
    # flip one byte deep inside a leaf of the next one: the full sha256
    # catches what a prefix hash would not
    leaf = max(glob.glob(os.path.join(steps[-2], "leaf_*.npy")),
               key=os.path.getsize)
    with open(leaf, "r+b") as f:
        f.seek(os.path.getsize(leaf) - 3)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 1]))
    cfg, opt, _ = _tiny()
    params = init_params(cfg, seed=0, device="cpu")
    step, restored = store.restore_latest(
        td, {"params": params, "opt": init_state(params, opt)})
    assert step == 5 and restored is not None


def test_checkpoint_atomicity(tmp_path):
    """A .tmp directory (a crash mid-write) is ignored by restore, and a
    save replaces a stale .tmp of its own step."""
    from repro_torch.checkpoint import store
    td = str(tmp_path)
    state = {"a": torch.arange(4), "b": torch.ones((2, 2)),
             "c": [torch.zeros(3, dtype=torch.bfloat16)]}
    store.save(td, 1, state)
    os.makedirs(os.path.join(td, "step_00000002.tmp"))
    step, restored = store.restore_latest(td, state)
    assert step == 1 and _equal(restored, state)
    assert restored["c"][0].dtype == torch.bfloat16
    store.save(td, 2, state)
    assert not os.path.exists(os.path.join(td, "step_00000002.tmp"))
    assert store.restore_latest(td, state)[0] == 2


def test_train_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--smoke", "--device", "cpu", "--steps", "2",
         "--seq-len", "64", "--global-batch", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "final loss" in res.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--smoke", "--device", "cpu", "--steps", "1",
         "--tp", "2"], env=env, capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and "not ported yet" in bad.stderr
