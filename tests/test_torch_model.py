"""The port's decoder forward (models/transformer.py) against the JAX
reference's, over paged caches: the smollm-360m smoke config with the
reference's own seeded weights carried through repro_torch.convert."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import smoke_models  # noqa: E402

# f32 logits after 4 layers: the two frameworks sum matmuls and attention
# in different orders and their exp/rsqrt/sin/cos differ by ulps, so the
# logits agree to ~1e-6 of their scale; 1e-4 (rtol and atol) leaves room
# for the growth of those differences through the layers, and is far
# below the gap a wrong mask, rotation or decode would open.
RTOL = ATOL = 1e-4


@pytest.mark.parametrize("posit,ptq", [("off", False), ("p16", True),
                                       ("p8", True), ("p16", False)],
                         ids=["off", "p16", "p8", "p16-float-weights"])
def test_paged_forward_logits_match_reference(posit, ptq):
    """Prefill a ragged chunk, then one decode step, through both
    forwards; the logits of every live position must agree.  The last
    case keeps float weights under the posit policy, which both sides
    round to posit values in the forward."""
    import jax.numpy as jnp
    from repro.models import transformer as RT
    from repro_torch.models import transformer as TT

    import jax
    cfg, params, tcfg, tparams = smoke_models(posit, ptq)
    ref_forward = jax.jit(lambda p, t, c: RT.forward(p, cfg, tokens=t,
                                                     caches=c))
    B, S, page, W = 3, 12, 4, 6
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    num_new = np.array([12, 7, 0], np.int32)       # ragged; slot 2 idle
    table = (1 + np.arange(B * W, dtype=np.int32)).reshape(B, W)
    zeros = np.zeros((B,), np.int32)

    pages = RT.init_paged_pages(cfg, num_pages=1 + B * W, page_size=page)
    caches = RT.assemble_paged_caches(pages, jnp.asarray(table),
                                      jnp.asarray(zeros),
                                      jnp.asarray(num_new))
    ref_logits, _, caches = ref_forward(params, jnp.asarray(toks), caches)
    ref_pages = RT.extract_paged_pages(caches)

    tpages = TT.init_paged_pages(tcfg, 1 + B * W, page, device="cpu")
    tcaches = TT.assemble_paged_caches(tpages, torch.from_numpy(table),
                                       torch.from_numpy(zeros),
                                       torch.from_numpy(num_new))
    logits, _, tcaches = TT.forward(tparams, tcfg,
                                    tokens=torch.from_numpy(toks),
                                    caches=tcaches)
    tpages = TT.extract_paged_pages(tcaches)
    for b in range(B):
        n = num_new[b]
        np.testing.assert_allclose(logits[b, :n].numpy(),
                                   np.asarray(ref_logits)[b, :n],
                                   rtol=RTOL, atol=ATOL)

    # one decode step for the two live slots
    step = np.array([[5], [9], [0]], np.int32)
    nn2 = np.array([1, 1, 0], np.int32)
    caches = RT.assemble_paged_caches(ref_pages, jnp.asarray(table),
                                      jnp.asarray(num_new), jnp.asarray(nn2))
    ref2, _, _ = ref_forward(params, jnp.asarray(step), caches)
    tcaches = TT.assemble_paged_caches(tpages, torch.from_numpy(table),
                                       torch.from_numpy(num_new),
                                       torch.from_numpy(nn2))
    out2, _, _ = TT.forward(tparams, tcfg, tokens=torch.from_numpy(step),
                            caches=tcaches)
    np.testing.assert_allclose(out2[:2].numpy(), np.asarray(ref2)[:2],
                               rtol=RTOL, atol=ATOL)
