"""Port parity: RMSNorm and rotary embeddings (full and partial) against
`otter_tpu/ops/layers.py`, f32, 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.ops import layers as jlayers
from otter_tpu_torch.ops import layers as tlayers

TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(2, 5, 32), (3, 4, 7, 16)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    ref = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-5)
    out = tlayers.rms_norm(_t(x), _t(w), eps=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_rms_norm_keeps_the_input_dtype():
    x = torch.randn(2, 8, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    assert tlayers.rms_norm(x, torch.ones(8)).dtype == torch.bfloat16


@pytest.mark.parametrize("dim,theta", [(16, 10000.0), (8, 25000.0)])
def test_rotary_tables_match_jax(dim, theta):
    ref = jlayers.rotary_tables(dim, 40, theta=theta)
    out = tlayers.rotary_tables(dim, 40, theta=theta)
    for o, r in zip(out, ref):
        assert o.shape == (40, dim)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("rotary_dim", [None, 8])
def test_apply_rotary_matches_jax(rotary_dim):
    """The whole head dim, and persimmon's partial form (the first 8 of 16
    channels rotate, the rest pass through)."""
    rng = np.random.default_rng(1)
    b, h, s, d = 2, 3, 6, 16
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, h, s, d)).astype(np.float32)
    positions = rng.integers(0, 40, (b, s)).astype(np.int32)
    rot = rotary_dim or d
    jcos, jsin = jlayers.rotary_tables(rot, 40)
    ref = jlayers.apply_rotary(jnp.asarray(q), jnp.asarray(k), jcos, jsin,
                               jnp.asarray(positions), rotary_dim=rotary_dim)
    cos, sin = tlayers.rotary_tables(rot, 40)
    out = tlayers.apply_rotary(_t(q), _t(k), cos, sin, _t(positions).long(),
                               rotary_dim=rotary_dim)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=TOL,
                                   rtol=TOL)
    if rotary_dim:
        np.testing.assert_array_equal(out[0][..., rot:].numpy(), q[..., rot:])
