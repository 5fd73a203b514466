"""Port parity: the whole tiny VLM's logits and cached decoding (prefill
into the stacked cache, then decode steps) against the JAX model built from
the same parameters, in f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.models.decoder import init_cache as jinit_cache
from otter_tpu_torch.models.decoder import init_cache
from torch_parity_helpers import inputs, jax_tiny, torch_tiny

MODULE_TOL = 1e-4
LOGIT_TOL = 1e-3   # the BASELINE.md logit-parity bar


def _close(out, ref, tol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def pair():
    cfg, jmodel, params, _ = jax_tiny()
    return cfg, params["params"], torch_tiny()


def test_otter_vlm_logits_match_jax(pair):
    cfg, _, tmodel = pair
    _, jmodel, params, _ = jax_tiny()
    vx, ids = inputs(cfg, 15, 2, 12, images=2)
    ids[:, 6] = cfg.media_token_id
    ref, _, _ = jax.jit(jmodel.apply)(params, jnp.asarray(vx),
                                      jnp.asarray(ids))
    with torch.no_grad():
        out, _, _ = tmodel(torch.from_numpy(vx), torch.from_numpy(ids).long())
    _close(out, ref, LOGIT_TOL)


@pytest.mark.parametrize("cache_dtype", ["int8", "f32"])
def test_cached_decode_matches_jax(pair, cache_dtype):
    """Prefill into the stacked cache, then two cached decode steps,
    through the decode-attention kernel path (`decode_kernel="auto"` takes
    it for the int8 cache) and the dense path (f32 cache). Tolerances: the
    prefill logits within 1e-4; decode-step logits within 1e-4 over the f32
    cache and within the 1e-3 logit bar over the int8 cache, where an entry
    whose value / scale sits near a half may be quantized one step apart
    by the two frameworks. Such an entry moves the next step's activations
    by about 1e-3, which moves further entries: so that one step's ties do
    not compound into the next, the port's int8 cache takes the JAX entries
    (checked to be at most one step away) after each comparison. A flip
    inside a step (the JAX kernel against every other path, the JAX dense
    path included) moves that step's logits by about 2e-3; the step tokens
    7 and 9 meet none, token 8 at the second step does."""
    cfg, _, tmodel = pair
    _, jmodel, params, _ = jax_tiny()
    b, p, L = 2, 10, 128
    vx, ids = inputs(cfg, 16, b, p)
    mask = np.ones_like(ids)
    mask[0, :3] = 0
    jdt, tdt = ((jnp.int8, torch.int8) if cache_dtype == "int8"
                else (jnp.float32, torch.float32))
    jcache = jinit_cache(cfg.text, b, L, jdt)
    tcache = init_cache(tmodel.cfg.text, b, L, tdt, "cpu")
    prefill = jax.jit(lambda vx, ids, mask, cache: jmodel.apply(
        params, vx, ids, attention_mask=mask, cache=cache,
        head_last_only=True))
    step = jax.jit(lambda tok, lat, cache, pos, kv_valid, counts: jmodel.apply(
        params, None, tok, vis_latents=lat, cache=cache, cache_pos=pos,
        kv_valid=kv_valid, media_counts=counts))
    jl, jcache, jlat = prefill(jnp.asarray(vx), jnp.asarray(ids),
                               jnp.asarray(mask), jcache)
    with torch.no_grad():
        tl, tcache, tlat = tmodel(torch.from_numpy(vx),
                                  torch.from_numpy(ids).long(),
                                  attention_mask=torch.from_numpy(mask),
                                  cache=tcache, head_last_only=True)
    _close(tl, jl, MODULE_TOL)

    def check_cache(n):
        for key in tcache:
            ref = np.array(jcache[key][:, :, :, :n], np.float32)
            _close(tcache[key][:, :, :, :n].float(), ref,
                   MODULE_TOL if key.endswith("scale") or cache_dtype == "f32"
                   else 1.0)   # int8 entries may differ by one step at a tie
            if cache_dtype == "int8":
                tcache[key][:, :, :, :n] = torch.from_numpy(ref).to(
                    tcache[key].dtype)

    check_cache(p)
    counts = (ids == cfg.media_token_id).sum(-1).astype(np.int32)
    kv_valid = np.zeros((b, L), bool)
    kv_valid[:, :p] = mask.astype(bool)
    for t in range(2):
        tok = np.full((b, 1), 7 + 2 * t, np.int32)
        kv_valid[:, p + t] = True
        jl, jcache, _ = step(jnp.asarray(tok), jlat, jcache, p + t,
                             jnp.asarray(kv_valid), jnp.asarray(counts))
        with torch.no_grad():
            tl, tcache, _ = tmodel(
                None, torch.from_numpy(tok).long(), vis_latents=tlat,
                cache=tcache, cache_pos=p + t,
                kv_valid=torch.from_numpy(kv_valid.copy()),
                media_counts=torch.from_numpy(counts))
        _close(tl, jl, LOGIT_TOL if cache_dtype == "int8" else MODULE_TOL)
        check_cache(p + t + 1)
