"""The port's CUDA kernels against their plain versions on the card, over
the edge cases the serving and training paths' shapes do not reach (other
head dims, "ge" ids, full-rank and broadcast biases, rows that attend
nothing, lengths that are not multiples of the tile, odd batch sizes,
biases and other activations in the MLP).

Needs an NVIDIA GPU; skipped without one. On the card:
`pytest -m cuda tests/test_torch_cuda.py`. Tolerance: bf16 in and out,
f32 inside, so |err| <= 2e-2 + 2e-2 |plain| for the forward kernels and
|err| <= 2e-2 max|plain| + 2e-2 |plain| for the backward kernels (their
outputs are sums over a whole sequence, so the error scales with the
largest gradient).
"""

import pytest
import torch

from otter_tpu_torch.ops import attention
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


def _close_grad(out, ref):
    torch.cuda.synchronize()
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    bound = 2e-2 * float(r.max()) + 2e-2 * r
    assert bool((d <= bound).all()), float(d.max())


def _backward_pair(gen, q, k, v, kw):
    """The kernels' (dq, dk, dv) and the plain backward's, for one random
    upstream gradient, from the kernel forward's out and lse."""
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    do = _rnd(gen, *out.shape)
    args = (q, k, v, kw.get("bias"), kw.get("q_ids"), kw.get("kv_ids"))
    opts = {n: kw[n] for n in ("causal", "ids_mode") if n in kw}
    before = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    kern = fa.flash_attention_bwd(*args, out, lse, do, **opts)
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == \
        (before[0] + 1, before[1] + 1)
    plain = fa.flash_attention_bwd_plain(*args, out, lse, do, **opts)
    return kern, plain


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("s", [64, 97])
def test_flash_backward_causal_alibi_ids(gen, d, s):
    b, h = 2, 3
    q, k, v = (_rnd(gen, b, h, s, d) for _ in range(3))
    bias = (torch.arange(1 - s, 1, device="cuda")[None, None, None, :]
            * torch.rand(1, h, 1, 1, generator=gen, device="cuda"))
    ids = torch.ones(b, s, dtype=torch.int32, device="cuda")
    ids[1, s - 20:] = 0
    kern, plain = _backward_pair(gen, q, k, v, dict(
        bias=bias, q_ids=ids, kv_ids=ids, causal=True))
    for a, r in zip(kern, plain):
        _close_grad(a, r)


@pytest.mark.parametrize("d", [16, 64])
def test_flash_backward_full_bias_unequal_lengths(gen, d):
    b, h, sq, sk = 2, 2, 70, 131
    q, k, v = _rnd(gen, b, h, sq, d), _rnd(gen, b, h, sk, d), \
        _rnd(gen, b, h, sk, d)
    bias = torch.randn(b, h, sq, sk, generator=gen, device="cuda")
    kern, plain = _backward_pair(gen, q, k, v, dict(bias=bias))
    for a, r in zip(kern, plain):
        _close_grad(a, r)


@pytest.mark.parametrize("mode", ["eq", "ge"])
@pytest.mark.parametrize("d", [32, 128])
def test_flash_backward_media_ids_and_masked_rows(gen, mode, d):
    """Rows with q_id 0 attend no key: their dq is 0 and their do reaches
    dv as 1/S_k, in both versions."""
    b, h, sq, sk = 2, 4, 33, 130
    q, k, v = _rnd(gen, b, h, sq, d), _rnd(gen, b, h, sk, d), \
        _rnd(gen, b, h, sk, d)
    q_ids = torch.randint(0, 3, (b, sq), generator=gen, device="cuda",
                          dtype=torch.int32)
    q_ids[:, 0] = 0
    kv_ids = torch.arange(1, 3, device="cuda", dtype=torch.int32
                          ).repeat_interleave(65)[None].expand(b, sk)
    kern, plain = _backward_pair(gen, q, k, v, dict(
        q_ids=q_ids, kv_ids=kv_ids, ids_mode=mode))
    for a, r in zip(kern, plain):
        _close_grad(a, r)
    dead = (q_ids == 0)[:, None, :, None].expand_as(kern[0])
    assert bool((kern[0][dead] == 0).all())


def test_loss_backward_through_the_dispatcher(gen):
    """loss.backward() through multi_head_attention at a kernel-routed
    shape reaches q, k and v through the two backward kernels, and agrees
    with autograd through the plain reference."""
    b, h, s, d = 2, 4, 80, 64
    leaves = [_rnd(gen, b, h, s, d).requires_grad_() for _ in range(3)]
    ids = torch.ones(b, s, dtype=torch.int32, device="cuda")
    ids[0, 60:] = 0
    kw = dict(q_ids=ids, kv_ids=ids, causal=True)
    before = (fa.flash_attention.launches, fa.flash_bwd_dkv.launches,
              fa.flash_bwd_dq.launches)
    w = _rnd(gen, b, h, s, d)
    (attention.multi_head_attention(*leaves, **kw).float() * w).sum() \
        .backward()
    after = (fa.flash_attention.launches, fa.flash_bwd_dkv.launches,
             fa.flash_bwd_dq.launches)
    assert all(a == x + 1 for a, x in zip(after, before)), (before, after)
    got = [t.grad for t in leaves]
    ref_leaves = [t.detach().clone().requires_grad_() for t in leaves]
    (attention.multi_head_attention(*ref_leaves, impl="ref", **kw).float()
     * w).sum().backward()
    for a, t in zip(got, ref_leaves):
        assert a is not None
        _close_grad(a, t.grad)


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
