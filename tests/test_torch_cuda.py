"""The port's CUDA kernels against their plain versions on the card, over
the edge cases the serving path's shapes do not reach (other head dims,
"ge" ids, full-rank and broadcast biases, rows that attend nothing, odd
batch sizes, biases and other activations in the MLP).

Needs an NVIDIA GPU; skipped without one. On the card:
`pytest -m cuda tests/test_torch_cuda.py`. Tolerance: bf16 in and out,
f32 inside, so |err| <= 2e-2 + 2e-2 |plain|.
"""

import pytest
import torch

from otter_tpu_torch.ops import decode_attention as da
from otter_tpu_torch.ops import flash_attention as fa
from otter_tpu_torch.ops import quant

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _close(out, ref, keep=None):
    torch.cuda.synchronize()
    d = (out.float() - ref.float()).abs()
    bound = 2e-2 + 2e-2 * ref.float().abs()
    if keep is not None:
        d, bound = d[keep], bound[keep]
    assert bool((d <= bound).all()), float(d.max())


def _rnd(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("bias_shape", [None, "full", "row"])
def test_flash_matches_plain(gen, d, bias_shape):
    b, h, s = 2, 3, 70
    q, k, v = (_rnd(gen, b, h, s, d) for _ in range(3))
    bias = None
    if bias_shape == "full":
        bias = torch.randn(b, h, s, s, generator=gen, device="cuda")
    elif bias_shape == "row":
        bias = torch.randn(1, h, 1, s, generator=gen, device="cuda")
    ids = torch.ones(b, s, dtype=torch.int32, device="cuda")
    ids[1, :30] = 0
    kw = dict(bias=bias, q_ids=ids, kv_ids=ids, causal=True)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    ref, rlse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    _close(out, ref)
    _close(lse, rlse)


@pytest.mark.parametrize("mode", ["eq", "ge"])
def test_flash_media_ids_and_masked_rows(gen, mode):
    b, h, sq, sk, d = 2, 4, 33, 130, 64
    q, k, v = _rnd(gen, b, h, sq, d), _rnd(gen, b, h, sk, d), \
        _rnd(gen, b, h, sk, d)
    q_ids = torch.randint(0, 3, (b, sq), generator=gen, device="cuda",
                          dtype=torch.int32)
    kv_ids = torch.arange(1, 3, device="cuda", dtype=torch.int32
                          ).repeat_interleave(65)[None].expand(b, sk)
    kw = dict(q_ids=q_ids, kv_ids=kv_ids, ids_mode=mode)
    # rows with q_id 0 attend no key: both versions average all of v
    _close(fa.flash_attention(q, k, v, **kw),
           fa.flash_attention_plain(q, k, v, **kw))


@pytest.mark.parametrize("m", [1, 3, 8, 20, 32])
def test_int8_mlp_matches_plain(gen, m):
    w1q, s1 = quant.quantize_kernel(0.05 * torch.randn(
        256, 512, generator=gen, device="cuda"))
    w2q, s2 = quant.quantize_kernel(0.05 * torch.randn(
        512, 192, generator=gen, device="cuda"))
    x = _rnd(gen, m, 256)
    _close(quant.int8_mlp(x, w1q, s1, w2q, s2),
           quant.int8_mlp_plain(x, w1q, s1, w2q, s2))


@pytest.mark.parametrize("act", ["relu", "silu", "sq_relu"])
def test_int8_mlp_bias_and_activations(gen, act):
    w1q, s1 = quant.quantize_kernel(0.05 * torch.randn(
        128, 256, generator=gen, device="cuda"))
    w2q, s2 = quant.quantize_kernel(0.05 * torch.randn(
        256, 64, generator=gen, device="cuda"))
    b1 = torch.randn(256, generator=gen, device="cuda")
    b2 = torch.randn(64, generator=gen, device="cuda")
    x = _rnd(gen, 5, 128)
    kw = dict(act=act, b1=b1, b2=b2)
    _close(quant.int8_mlp(x, w1q, s1, w2q, s2, **kw),
           quant.int8_mlp_plain(x, w1q, s1, w2q, s2, **kw))


def test_int8_mlp_is_deterministic(gen):
    w1q, s1 = quant.quantize_kernel(0.02 * torch.randn(
        1024, 4096, generator=gen, device="cuda"))
    w2q, s2 = quant.quantize_kernel(0.02 * torch.randn(
        4096, 1024, generator=gen, device="cuda"))
    x = _rnd(gen, 8, 1024)
    first = quant.int8_mlp(x, w1q, s1, w2q, s2)
    for _ in range(3):
        assert torch.equal(quant.int8_mlp(x, w1q, s1, w2q, s2), first)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_decode_attention_matches_plain(gen, int8, d):
    b, nl, h, L = 4, 3, 4, 200
    q = _rnd(gen, b, h, d)
    k, v = _rnd(gen, b, nl, h, L, d), _rnd(gen, b, nl, h, L, d)
    kw = {}
    if int8:
        (k, ks), (v, vs) = quant.quantize_kv(k), quant.quantize_kv(v)
        kw = dict(k_scale=ks, v_scale=vs)
    lengths = torch.tensor([200, 1, 77, 40], device="cuda")
    starts = torch.tensor([0, 0, 33, 40], device="cuda")  # last row: empty
    bias = torch.randn(b, 1, L, generator=gen, device="cuda")
    out = da.decode_attention(q, k, v, lengths, bias, starts, layer=2, **kw)
    ref = da.decode_attention_plain(q, k, v, lengths, bias, starts, layer=2,
                                    **kw)
    keep = (lengths > starts)[:, None, None].expand_as(out)
    _close(out, ref, keep)
    assert bool((out[3] == 0).all())   # nothing to attend: zeros
