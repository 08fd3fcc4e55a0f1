"""The port's posit codec (core/decode.py, core/convert.py and the plain
version of the codec kernel) against the JAX reference, bit for bit."""
from __future__ import annotations

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

CFGS = ["P8_0", "P8_2", "P16_1", "P16_2"]


def _cfgs(name):
    ref_types = importlib.import_module("repro.core.types")
    port_types = importlib.import_module("repro_torch.core.types")
    return getattr(ref_types, name), getattr(port_types, name)


def _all_patterns(cfg) -> np.ndarray:
    n = cfg.n
    return np.arange(-(1 << (n - 1)), 1 << (n - 1)).astype(
        f"int{cfg.storage_bits}")


def _f32_sweep(cfg, ref_cfg) -> np.ndarray:
    """Specials, subnormals, random bit patterns, and every posit value of
    the format nudged one f32 ulp either way (the rounding boundaries)."""
    import jax.numpy as jnp
    from repro.core.decode import decode_to_f32
    rng = np.random.default_rng(0)
    specials = np.array([0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                         0xFFC00001, 1, 0x80000001, 0x007FFFFF, 0x00400000,
                         0x7F7FFFFF, 0xFF7FFFFF], np.uint32).view(np.int32)
    vals = np.asarray(decode_to_f32(jnp.asarray(_all_patterns(cfg)),
                                    ref_cfg))
    vals = vals[np.isfinite(vals)].astype(np.float32)
    near = np.concatenate([vals, np.nextafter(vals, np.float32(np.inf)),
                           np.nextafter(vals, np.float32(-np.inf))])
    mids = ((vals[1:] + vals[:-1]) / 2).astype(np.float32)
    return np.concatenate([
        specials.view(np.float32),
        rng.integers(-2 ** 31, 2 ** 31, 100_000).astype(np.int32)
           .view(np.float32),
        np.arange(0, 1 << 23, 4099, dtype=np.int32).view(np.float32),
        near, mids])


@pytest.mark.parametrize("name", CFGS)
def test_decode_to_f32_bit_exact_all_patterns(name):
    import jax.numpy as jnp
    from repro.core.decode import decode_to_f32 as ref_decode
    from repro_torch.core.decode import decode_to_f32
    ref_cfg, cfg = _cfgs(name)
    pats = _all_patterns(ref_cfg)
    want = np.asarray(ref_decode(jnp.asarray(pats), ref_cfg)).view(np.int32)
    got = decode_to_f32(torch.from_numpy(pats), cfg).numpy().view(np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CFGS)
def test_f32_to_posit_bit_exact_on_sweep(name):
    import jax.numpy as jnp
    from repro.core.convert import f32_to_posit as ref_encode
    from repro_torch.core.convert import f32_to_posit
    ref_cfg, cfg = _cfgs(name)
    sweep = _f32_sweep(ref_cfg, ref_cfg)
    want = np.asarray(ref_encode(jnp.asarray(sweep), ref_cfg))
    got = f32_to_posit(torch.from_numpy(sweep), cfg).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["P8_2", "P16_2"])
def test_codec_wrappers_take_plain_versions_on_cpu(name):
    """On CPU tensors the kernel wrappers run their plain versions (and
    count them), never a launch; the round trip is exact."""
    from repro_torch.kernels import ops, posit_codec
    _, cfg = _cfgs(name)
    ops.reset_counters()
    pats = torch.from_numpy(_all_patterns(cfg))
    vals = posit_codec.decode_block(pats, cfg)
    back = posit_codec.encode_block(vals, cfg)
    nar = pats == -(1 << (cfg.n - 1))
    assert torch.equal(back[~nar], pats[~nar]) and bool(torch.isnan(
        vals[nar]).all())
    assert ops.plain_counts()["decode_block"] == 1
    assert ops.plain_counts()["encode_block"] == 1
    assert sum(ops.launch_counts().values()) == 0


def test_positarray_format_mismatch_raises():
    from repro_torch.core.array import PositArray, PositConfigMismatchError
    from repro_torch.core.types import P8_2, P16_2
    a = PositArray(torch.zeros(3, dtype=torch.int16), P16_2)
    b = PositArray(torch.zeros(3, dtype=torch.int8), P8_2)
    with pytest.raises(PositConfigMismatchError):
        a.same_format(b)
    with pytest.raises(TypeError):
        PositArray(torch.zeros(3, dtype=torch.int8), P16_2)
    assert a[1:].shape == (2,) and a.nbytes == 6
    assert torch.equal(a.to_f32(), torch.zeros(3))
