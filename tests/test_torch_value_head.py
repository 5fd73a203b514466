"""Port parity of the RLHF value head (`otter_tpu_torch.train.value_head`)
against the JAX package's (`otter_tpu.train.value_head`) on the tiny MPT
decoder in f32 on the CPU: logits and values within 1e-5 in eval mode;
dropout in training mode drawn from the head's `torch.Generator`
(reproducible from its seed, flax's keep-and-rescale rule)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from otter_tpu.config import OtterConfig
from otter_tpu.train.value_head import DecoderWithValueHead as JaxDWVH
from otter_tpu_torch.config import TextConfig
from otter_tpu_torch.models.convert import load_flax_params
from otter_tpu_torch.train.value_head import DecoderWithValueHead, ValueHead


def _pair(seed=0):
    cfg = OtterConfig.tiny("mpt").text
    jm = JaxDWVH(cfg)
    ids = np.random.default_rng(seed).integers(0, 200, (2, 10)).astype(
        np.int32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(ids))["params"]
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    flat["v_head/summary/bias"] = np.full((1,), 0.3, np.float32)
    params = traverse_util.unflatten_dict(flat, sep="/")
    model = DecoderWithValueHead(TextConfig.from_dict(cfg.to_dict()),
                                 dtype=torch.float32, device="cpu")
    load_flax_params(model, flat)
    return jm, params, model, ids


def test_logits_and_values_match_jax():
    jm, params, model, ids = _pair()
    mask = np.ones_like(ids)
    mask[1, :3] = 0
    ref_l, ref_v = jm.apply({"params": params}, jnp.asarray(ids),
                            attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        logits, values = model(torch.from_numpy(ids).long(),
                               attention_mask=torch.from_numpy(mask))
    assert values.shape == (2, 10)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_l), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(values.numpy(), np.asarray(ref_v), atol=1e-5,
                               rtol=0)
    with torch.no_grad():
        again = model(torch.from_numpy(ids).long(),
                      attention_mask=torch.from_numpy(mask))[1]
    torch.testing.assert_close(again, values, atol=0, rtol=0)


def test_training_dropout_follows_the_seed_and_the_rate():
    hidden = torch.ones(4, 500, 64)
    heads = [ValueHead(64, dropout=0.25, device="cpu", seed=s)
             for s in (1, 1, 2)]
    for h in heads:
        with torch.no_grad():
            h.summary.kernel.fill_(1.0)
            h.summary.bias.zero_()
    with torch.no_grad():
        a, b, c = (h(hidden, deterministic=False) for h in heads)
        ev = heads[0](hidden)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
    torch.testing.assert_close(ev, torch.full_like(ev, 64.0))
    # kept units scaled by 1 / (1 - p): every value is a multiple of 4/3,
    # and the mean stays 64 (the kept share 0.75 within 0.01)
    np.testing.assert_allclose((a * 0.75).round().numpy(),
                               (a * 0.75).numpy(), atol=1e-3)
    assert abs(float(a.mean()) - 64.0) < 0.64
