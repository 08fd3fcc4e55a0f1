"""The plain versions of the port's paged attention (decode and prefill)
and of its fused KV append, against repro.serving.paged_kv on CPU.

Pools hold float, posit8 or posit16 pages; lengths are ragged, tables
carry garbage-page tails, and the cases cover a window, a softcap and a
mid-prefill q_offset.  The routing is the port's own
(serving.paged_kv.paged_attention), so the decode and prefill wrappers
are both reached.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import port_posit  # noqa: E402

# both sides decode the pages exactly and run the same two-pass (Sq == 1)
# or chunked online softmax in f32; only summation order and libm ulps
# differ, ~1e-7 on outputs bounded by max|v| ~ 4
RTOL = ATOL = 1e-5

B, H, N_KV, D, PAGE, W, POOL = 3, 6, 2, 16, 4, 6, 24


def _pool(posit, rng):
    import jax.numpy as jnp
    from repro.core.array import PositArray as RefPositArray
    from repro.core.convert import f32_to_posit
    from repro.core.types import P8_2, P16_2
    from repro_torch.core.array import PositArray
    ref_cfg = {"p8": P8_2, "p16": P16_2}.get(posit)
    kv = rng.standard_normal((2, POOL, N_KV, PAGE, D)).astype(np.float32)
    if ref_cfg is None:
        return (jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                torch.from_numpy(kv[0].copy()),
                torch.from_numpy(kv[1].copy()))
    bits = [np.array(f32_to_posit(jnp.asarray(x), ref_cfg)) for x in kv]
    cfg = port_posit(ref_cfg)
    return (RefPositArray(jnp.asarray(bits[0]), ref_cfg),
            RefPositArray(jnp.asarray(bits[1]), ref_cfg),
            PositArray(torch.from_numpy(bits[0].copy()), cfg),
            PositArray(torch.from_numpy(bits[1].copy()), cfg))


def _table(rng, seq_lens):
    """Distinct pages for each sequence's live positions; the tail of each
    row points at the garbage page or at other sequences' pages."""
    table = rng.integers(0, POOL, (B, W)).astype(np.int32)
    perm = rng.permutation(np.arange(1, POOL))
    used = 0
    for b, sl in enumerate(seq_lens):
        n = -(-int(sl) // PAGE)
        table[b, :n] = perm[used:used + n]
        used += n
    return table


CASES = {
    # name: (Sq, seq_lens post-append, q_offset, causal, window, softcap)
    "decode": (1, [1, 13, 24], None, True, None, None),
    "decode_window": (1, [2, 13, 24], None, True, 5, None),
    "decode_softcap": (1, [3, 9, 24], None, True, None, 2.0),
    "prefill_first_chunk": (8, [8, 5, 8], [0, 0, 0], True, None, None),
    "prefill_mid_chunk": (8, [16, 13, 24], [8, 8, 16], True, None, None),
    "prefill_window": (8, [16, 11, 24], [8, 3, 16], True, 6, None),
    "prefill_softcap": (8, [16, 13, 20], [8, 8, 12], True, None, 1.5),
}


@pytest.mark.parametrize("posit", ["float", "p8", "p16"])
@pytest.mark.parametrize("case", list(CASES))
def test_paged_attention_plain_matches_reference(case, posit):
    import jax.numpy as jnp
    from repro.serving.paged_kv import paged_attention as ref_attention
    from repro_torch.kernels import ops
    from repro_torch.serving.paged_kv import paged_attention

    Sq, seq_lens, q_offset, causal, window, softcap = CASES[case]
    rng = np.random.default_rng(len(case) * 7 + len(posit))
    rk, rv, tk, tv = _pool(posit, rng)
    sl = np.asarray(seq_lens, np.int32)
    table = _table(rng, sl)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    qo = None if q_offset is None else np.asarray(q_offset, np.int32)
    num_new = sl - (sl - 1 if qo is None else qo)

    ref_cache = {"k_pages": rk, "v_pages": rv,
                 "page_table": jnp.asarray(table), "seq_lens": jnp.asarray(sl),
                 "num_new": jnp.asarray(num_new)}
    want = ref_attention(jnp.asarray(q), ref_cache, n_kv=N_KV, causal=causal,
                         q_offset=None if qo is None else jnp.asarray(qo),
                         window=window, softcap=softcap)
    cache = {"k_pages": tk, "v_pages": tv,
             "page_table": torch.from_numpy(table),
             "seq_lens": torch.from_numpy(sl),
             "num_new": torch.from_numpy(num_new)}
    ops.reset_counters()
    got = paged_attention(torch.from_numpy(q), cache, n_kv=N_KV,
                          causal=causal,
                          q_offset=None if qo is None else torch.from_numpy(qo),
                          window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    routed = ("paged_flash_decode" if Sq == 1 and softcap is None
              else "paged_flash_prefill")
    assert ops.plain_counts()[routed] == 1
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.parametrize("posit", ["float", "p8", "p16"])
def test_paged_append_matches_reference_bit_exact(posit):
    """Masked tokens (j >= num_new) and positions past the table are
    dropped; everything else lands bit-identical to the reference."""
    import jax.numpy as jnp
    from repro.serving.paged_kv import paged_append_kv as ref_append
    from repro_torch.serving.paged_kv import paged_append_kv

    rng = np.random.default_rng(11)
    rk, rv, tk, tv = _pool(posit, rng)
    S = 6
    sl = np.array([0, 9, 20], np.int32)       # slot 2 runs past the table
    num_new = np.array([6, 2, 6], np.int32)
    table = _table(rng, np.minimum(sl + num_new, W * PAGE))
    k = rng.standard_normal((B, N_KV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, N_KV, S, D)).astype(np.float32)

    want = ref_append({"k_pages": rk, "v_pages": rv,
                       "page_table": jnp.asarray(table),
                       "seq_lens": jnp.asarray(sl),
                       "num_new": jnp.asarray(num_new)},
                      jnp.asarray(k), jnp.asarray(v))
    got = paged_append_kv({"k_pages": tk, "v_pages": tv,
                           "page_table": torch.from_numpy(table),
                           "seq_lens": torch.from_numpy(sl),
                           "num_new": torch.from_numpy(num_new)},
                          torch.from_numpy(k), torch.from_numpy(v))
    for key in ("k_pages", "v_pages"):
        w, g = want[key], got[key]
        w = np.asarray(getattr(w, "bits", w))
        g = getattr(g, "bits", g).numpy()
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    np.testing.assert_array_equal(got["seq_lens"].numpy(),
                                  np.asarray(want["seq_lens"]))


@pytest.mark.parametrize("posit", ["float", "p8", "p16"])
def test_gather_kv_matches_reference_bit_exact(posit):
    """The dense view of the pool is position-identical to the
    reference's (posit pages stay posit bits)."""
    import jax.numpy as jnp
    from repro.serving.paged_kv import gather_kv as ref_gather
    from repro_torch.serving.paged_kv import gather_kv

    rng = np.random.default_rng(5)
    rk, rv, tk, tv = _pool(posit, rng)
    table = _table(rng, np.array([9, 24, 1], np.int32))
    want = ref_gather({"k_pages": rk, "v_pages": rv,
                       "page_table": jnp.asarray(table)})
    got = gather_kv({"k_pages": tk, "v_pages": tv,
                     "page_table": torch.from_numpy(table)})
    for w, g in zip(want, got):
        assert hasattr(w, "bits") == hasattr(g, "bits") == (posit != "float")
        w = np.asarray(getattr(w, "bits", w))
        g = getattr(g, "bits", g).numpy()
        assert g.shape == (B, N_KV, W * PAGE, D)
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
