"""The port's PagedServingEngine against the JAX reference's, and the
port's serving CLI.

Both engines drain the same mixed-length requests over the same smoke
weights (the reference's init + PTQ, carried through repro_torch.convert)
with a pool small enough to force preemption.  Greedy tokens must be
identical: the port's forward matches the reference's logits to ~1e-6
(tests/test_torch_model.py), far inside the gap between the top two
logits of these requests.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import CopyingJnp, smoke_models  # noqa: E402

ENGINE_KW = dict(max_seqs=3, page_size=8, table_width=4, num_pages=7,
                 prefill_chunk=8)


def _requests(vocab: int):
    rng = np.random.default_rng(7)
    lens = [5, 17, 9, 23, 3, 12]
    return [(rng.integers(0, vocab, n).astype(np.int32), 8) for n in lens]


@pytest.mark.parametrize("posit", ["off", "p16", "p8"])
def test_engine_greedy_tokens_match_reference(posit, monkeypatch):
    from repro.serving import engine as ref_engine
    from repro.serving.engine import PagedServingEngine as RefEngine
    from repro_torch.serving.engine import PagedServingEngine

    # snapshot the reference's host scheduler arrays per step (see
    # CopyingJnp: without it the reference's own tokens vary run to run)
    monkeypatch.setattr(ref_engine, "jnp", CopyingJnp())

    cfg, params, tcfg, tparams = smoke_models(posit)
    reqs = _requests(cfg.vocab)
    ref = RefEngine(params, cfg, prefix_cache=False, **ENGINE_KW)
    ref_out = ref.run([(p.copy(), n) for p, n in reqs])
    eng = PagedServingEngine(tparams, tcfg, device="cpu", **ENGINE_KW)
    out = eng.run([(p.copy(), n) for p, n in reqs])

    assert ref.counters["preempted"] >= 1, "traffic did not preempt"
    assert eng.counters["preempted"] == ref.counters["preempted"]
    assert sorted(out) == sorted(ref_out) == list(range(len(reqs)))
    for rid in ref_out:
        np.testing.assert_array_equal(out[rid], ref_out[rid], err_msg=rid)
    stats = eng.stats()
    assert stats["completed"] == len(reqs) and stats["failed_nar"] == 0
    assert (stats["prefill_steps"], stats["decode_steps"]) == (
        ref.counters["prefill_steps"], ref.counters["decode_steps"])


def test_nar_in_one_sequence_fails_only_that_request():
    """A NaR written into one live sequence's KV pages trips the per-slot
    NaR flag for that request only; its pages are scrubbed before they
    return to the pool, and every other request completes."""
    from repro_torch.serving.engine import PagedServingEngine
    _, _, tcfg, tparams = smoke_models("p16")
    reqs = _requests(tcfg.vocab)[:3]
    eng = PagedServingEngine(tparams, tcfg, device="cpu", **ENGINE_KW)
    for prompt, n in reqs:
        eng.submit(prompt, n)
    while not any(s is not None and s.generated for s in eng.slots):
        eng.step()
    victim = next(i for i, s in enumerate(eng.slots)
                  if s is not None and s.generated)
    rid = eng.slots[victim].req.rid
    page = eng.slots[victim].pages[0]
    nar = -(1 << (tcfg.policy.kv_cache.n - 1))
    for layer in eng.pages["layers"]:
        layer["k_pages"].bits[page] = nar
    eng.run()
    assert eng.outcomes[rid].status == "failed_nar"
    assert all(o.status == "completed" for r, o in eng.outcomes.items()
               if r != rid)
    assert len(eng.outcomes) == len(reqs)
    assert eng.counters["scrubbed_pages"] >= 1
    assert not any(bool((layer["k_pages"].bits == nar).any())
                   for layer in eng.pages["layers"])


def test_engine_rejects_unported_features():
    from repro_torch.serving.engine import PagedServingEngine
    _, _, tcfg, tparams = smoke_models("off")
    for kw in ({"prefix_cache": True}, {"mesh": object()},
               {"chaos": object()}, {"default_ttl_steps": 3},
               {"temperature": 0.7}):
        with pytest.raises(NotImplementedError):
            PagedServingEngine(tparams, tcfg, device="cpu", **kw)


def test_serve_cli_drains_on_cpu():
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "smollm-360m", "--smoke", "--engine", "paged", "--batch", "2",
           "--prompt-len", "12", "--max-new", "3", "--posit", "p16",
           "--requests", "3", "--device", "cpu"]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "completed=3 rejected=0 failed_nar=0" in res.stdout
    assert res.stdout.count("[serve] rid ") == 3
    bad = subprocess.run(cmd + ["--mesh", "2x1"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and "not ported yet" in bad.stderr
