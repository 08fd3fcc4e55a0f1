"""The plain version of the port's posit-weight GEMM (kernels/ops.py
pw_matmul on CPU) against repro.kernels.ops.pw_matmul on CPU."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# both sides decode the weights exactly and accumulate in f32; they differ
# only in summation order, which moves a K <= 320 dot product of values
# ~1 by ~1e-6 at most
RTOL = ATOL = 1e-5


@pytest.mark.parametrize("posit", ["p8", "p16"])
@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("lead,k,n", [((1,), 120, 360), ((2, 9), 320, 120),
                                      ((4, 3), 120, 512)])
def test_pw_matmul_plain_matches_reference(posit, transpose_b, lead, k, n):
    import jax.numpy as jnp
    from repro.core.array import PositArray as RefPositArray
    from repro.core.types import P8_2, P16_2
    from repro.kernels import ops as ref_ops
    from repro_torch.core.array import PositArray
    from repro_torch.kernels import ops
    from torch_parity import port_posit

    ref_cfg = {"p8": P8_2, "p16": P16_2}[posit]
    cfg = port_posit(ref_cfg)
    rng = np.random.default_rng(k * n + transpose_b)
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    wshape = (n, k) if transpose_b else (k, n)
    # PTQ'd weights, as the serving path holds them, plus the special
    # patterns: zero, NaR (a NaN column) and +-maxpos, +-minpos
    from repro.core.convert import f32_to_posit
    w = rng.standard_normal(wshape).astype(np.float32) * k ** -0.5
    bits = np.array(f32_to_posit(jnp.asarray(w), ref_cfg))
    specials = [0, -(1 << (cfg.n - 1)), cfg.maxpos_bits, -cfg.maxpos_bits,
                1, -1]
    flat = bits.reshape(-1)
    flat[rng.choice(flat.size, len(specials), replace=False)] = specials

    want = ref_ops.pw_matmul(jnp.asarray(x), RefPositArray(jnp.asarray(bits),
                                                           ref_cfg),
                             transpose_b=transpose_b)
    ops.reset_counters()
    got = ops.pw_matmul(torch.from_numpy(x),
                        PositArray(torch.from_numpy(bits), cfg),
                        transpose_b=transpose_b)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert ops.plain_counts()["pw_gemm"] == 1
    assert ops.launch_counts()["pw_gemm"] == 0


def test_pw_gemm_rejects_unported_modes():
    from repro_torch.core.types import P16_2
    from repro_torch.kernels.posit_gemm import pw_gemm
    x = torch.zeros(2, 4)
    w = torch.zeros(4, 3, dtype=torch.int16)
    for kw in ({"out_posit": True}, {"transpose_a": True}):
        with pytest.raises(NotImplementedError):
            pw_gemm(x, w, P16_2, **kw)
