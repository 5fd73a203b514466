"""The port's CUDA kernels against their plain versions on the card, over
the edge cases the serving and training paths' shapes do not reach (other
head dims, "ge" ids, full-rank and broadcast biases, rows that attend
nothing, lengths that are not multiples of the tile, odd batch sizes,
biases and other activations in the MLP, the fused decode layer's two
kernels at small widths, the ends of the cache and refused inputs).

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
from otter_tpu_torch.ops import megakernel as mk
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


def _int4_pair(gen, k, h, n):
    w1p, s1 = quant.quantize_kernel_int4(0.05 * torch.randn(
        k, h, generator=gen, device="cuda"), 0)
    w2p, s2 = quant.quantize_kernel_int4(0.05 * torch.randn(
        h, n, generator=gen, device="cuda"), 1)
    return w1p, s1, w2p, s2


@pytest.mark.parametrize("m", [1, 5, 8, 20, 32])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
def test_int4_mlp_matches_plain(gen, m, act):
    # N/2 = 96: a pass narrower than the threads' 8-byte columns cover
    w = _int4_pair(gen, 256, 512, 192)
    x = _rnd(gen, m, 256)
    before = quant.int4_mlp.launches
    out = quant.int4_mlp(x, *w, act=act)
    assert quant.int4_mlp.launches == before + 1
    _close(out, quant.int4_mlp_plain(x, *w, act=act))


def test_int4_mlp_wide_output_and_determinism(gen):
    # N/2 = 2560: more than one 2048-column pass of packed W2
    w = _int4_pair(gen, 1024, 2048, 5120)
    x = _rnd(gen, 8, 1024)
    first = quant.int4_mlp(x, *w)
    _close(first, quant.int4_mlp_plain(x, *w))
    for _ in range(3):
        assert torch.equal(quant.int4_mlp(x, *w), first)


@pytest.mark.parametrize("m", [1, 5, 32])
@pytest.mark.parametrize("k,n", [(256, 384), (1024, 128), (4096, 4096)])
def test_int4_matmul_matches_plain(gen, m, k, n):
    wp, scale = quant.quantize_kernel_int4(0.05 * torch.randn(
        k, n, generator=gen, device="cuda"), 0)
    x = _rnd(gen, m, k)
    before = quant.int4_matmul.launches
    out = quant.int4_matmul(x, wp, scale)
    assert quant.int4_matmul.launches == before + 1
    _close(out, quant.int4_matmul_plain(x, wp, scale))
    assert torch.equal(quant.int4_matmul(x, wp, scale), out)


def test_int4_attn_dense_routes_by_token_count(gen):
    dense = quant.Int4AttnDense(256, 384, device="cuda")
    wp, scale = quant.quantize_kernel_int4(0.05 * torch.randn(
        256, 384, generator=gen, device="cuda"), 0)
    dense.kernel_q4.copy_(wp)
    dense.scale_q.copy_(scale)
    before = quant.int4_matmul.launches
    few, many = _rnd(gen, 2, 4, 256), _rnd(gen, 2, 40, 256)
    _close(dense(few), quant.int4_matmul_plain(
        few.reshape(8, 256), wp, scale).reshape(2, 4, 384))
    assert quant.int4_matmul.launches == before + 1
    _close(dense(many), quant.int4_matmul_plain(
        many.reshape(80, 256), wp, scale).reshape(2, 40, 384))
    assert quant.int4_matmul.launches == before + 1


def test_int4_kernels_raise_instead_of_copying(gen):
    w1p, s1, w2p, s2 = _int4_pair(gen, 256, 512, 192)
    x = _rnd(gen, 4, 256)
    with pytest.raises(ValueError, match="contiguous"):   # a strided view
        quant.int4_mlp(_rnd(gen, 4, 512)[:, ::2], w1p, s1, w2p, s2)
    with pytest.raises(ValueError, match="aligned"):      # off by one byte
        flat = torch.empty(w1p.numel() + 1, dtype=torch.int8, device="cuda")
        quant.int4_mlp(x, flat[1:].view_as(w1p), s1, w2p, s2)
    with pytest.raises(ValueError):                       # M > 32
        quant.int4_mlp(_rnd(gen, 33, 256), w1p, s1, w2p, s2)
    with pytest.raises(TypeError):                        # f32 x
        quant.int4_mlp(x.float(), w1p, s1, w2p, s2)
    with pytest.raises(ValueError):                       # K % 128
        wp, sc = quant.quantize_kernel_int4(torch.randn(
            64, 128, generator=gen, device="cuda"), 0)
        quant.int4_matmul(_rnd(gen, 2, 64), wp, sc)


def _int4_cache(gen, b, nl, h, L, d):
    return quant.quantize_kv_int4(_rnd(gen, b, nl, h, L, d),
                                  _rnd(gen, b, nl, h, L, d))


@pytest.mark.parametrize("d", [64, 128])
def test_decode_attention_int4_matches_plain(gen, d):
    """Ragged spans: one inside a single 32-key chunk, one of a single key,
    one crossing chunks from an unaligned start, one empty (zeros, no
    NaN)."""
    b, nl, h, L = 4, 3, 4, 200
    q = _rnd(gen, b, h, d)
    kv, ks, vs = _int4_cache(gen, b, nl, h, L, d)
    lengths = torch.tensor([60, 1, 177, 40], device="cuda")
    starts = torch.tensor([35, 0, 33, 40], device="cuda")  # last row: empty
    bias = torch.randn(b, 1, L, generator=gen, device="cuda")
    kw = dict(k_scale=ks, v_scale=vs, kv_bits=4, layer=2)
    before = (da.decode_attention.launches, da.decode_attention.launches_int4)
    out = da.decode_attention(q, kv, kv, lengths, bias, starts, **kw)
    assert (da.decode_attention.launches,
            da.decode_attention.launches_int4) == (before[0] + 1,
                                                   before[1] + 1)
    ref = da.decode_attention_plain(q, kv, kv, lengths, bias, starts, **kw)
    keep = (lengths > starts)[:, None, None].expand_as(out)
    _close(out, ref, keep)
    assert bool(torch.isfinite(out).all())
    assert bool((out[3] == 0).all())   # nothing to attend: zeros


def test_decode_attention_int4_single_layer_no_bias(gen):
    b, h, L, d = 2, 4, 96, 128
    q = _rnd(gen, b, h, d)
    kv, ks, vs = quant.quantize_kv_int4(_rnd(gen, b, h, L, d),
                                        _rnd(gen, b, h, L, d))
    lengths = torch.tensor([96, 50], device="cuda")
    kw = dict(k_scale=ks, v_scale=vs, kv_bits=4)
    _close(da.decode_attention(q, kv, kv, lengths, **kw),
           da.decode_attention_plain(q, kv, kv, lengths, **kw))


def test_decode_attention_int4_reads_the_cache_in_place(gen):
    b, nl, h, L, d = 2, 2, 4, 64, 128
    q = _rnd(gen, b, h, d)
    kv, ks, vs = _int4_cache(gen, b, nl, h, L, d)
    lengths = torch.tensor([64, 30], device="cuda")
    kw = dict(k_scale=ks, v_scale=vs, kv_bits=4, layer=1)
    with pytest.raises(ValueError, match="one fused array"):   # a copy as v
        da.decode_attention(q, kv, kv.clone(), lengths, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros(b, nl, h, L, 2 * d, dtype=torch.int8,
                           device="cuda")[..., :d]
        da.decode_attention(q, wide, wide, lengths, **kw)
    with pytest.raises(ValueError, match="misaligned"):
        flat = torch.zeros(kv.numel() + 1, dtype=torch.int8, device="cuda")
        off = flat[1:].view_as(kv)
        da.decode_attention(q, off, off, lengths, **kw)


def test_int4_write_cache_then_decode_on_the_card(gen):
    """The model's own path on CUDA tensors: `write_cache` quantizes a new
    row into the fused cache in place (per-row offsets too), and the kernel
    reads what was written."""
    from otter_tpu_torch.config import OtterConfig
    from otter_tpu_torch.models.decoder import init_cache, write_cache
    c = OtterConfig.tiny("mpt").text.replace(
        num_attention_heads=4, hidden_size=512)
    b, L = 3, 64
    d, h = c.head_dim, c.kv_heads
    cache = init_cache(c, b, L, "int4", "cuda")
    k0, v0 = _rnd(gen, b, h, 20, d), _rnd(gen, b, h, 20, d)
    write_cache(cache, 1, k0, v0, 0)
    k1, v1 = _rnd(gen, b, h, 1, d), _rnd(gen, b, h, 1, d)
    pos = torch.tensor([20, 25, 21], device="cuda")
    write_cache(cache, 1, k1, v1, pos)
    q = _rnd(gen, b, h, d)
    valid = torch.zeros(b, L, dtype=torch.bool, device="cuda")
    valid[:, :20] = True
    valid[torch.arange(b), pos] = True
    # spans cover the gap rows 1 and 2 leave before their new entry: the
    # zero bytes there dequantize to 0 under a 0 scale in both versions
    lengths = pos + 1
    kw = dict(k_scale=cache["k_scale"], v_scale=cache["v_scale"], kv_bits=4,
              layer=1)
    _close(da.decode_attention(q, cache["kv"], cache["kv"], lengths, **kw),
           da.decode_attention_plain(q, cache["kv"], cache["kv"], lengths,
                                     **kw))


# ── the fused decode layer: int8_attn_tail and decode_attn_megakernel ──

def _qk(gen, rows, cols):
    return quant.quantize_kernel(0.05 * torch.randn(
        rows, cols, generator=gen, device="cuda"))


def _tail_args(gen, m, hd=256, d=256, hid=512):
    (wo, so), (w1, s1), (w2, s2) = _qk(gen, hd, d), _qk(gen, d, hid), \
        _qk(gen, hid, d)
    g = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    return (_rnd(gen, m, hd), _rnd(gen, m, d), wo, so, g, w1, s1, w2, s2)


@pytest.mark.parametrize("m", [1, 5, 8, 9, 32])
@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_attn_tail_matches_plain(gen, m, act):
    args = _tail_args(gen, m)
    before = quant.int8_attn_tail.launches
    out = quant.int8_attn_tail(*args, act=act)
    assert quant.int8_attn_tail.launches == before + 1
    _close(out, quant.int8_attn_tail_plain(*args, act=act))
    again = quant.int8_attn_tail(*args, act=act)
    torch.cuda.synchronize()
    assert torch.equal(out, again)   # sums in a fixed order


def test_attn_tail_rectangular_out_proj(gen):
    # hd != D (an out-projection that is not square), H not a power of two
    args = _tail_args(gen, 3, hd=128, d=384, hid=640)
    _close(quant.int8_attn_tail(*args), quant.int8_attn_tail_plain(*args))


def test_attn_tail_refuses_what_the_kernel_does_not_take(gen):
    a, r, wo, so, g, w1, s1, w2, s2 = _tail_args(gen, 4)
    with pytest.raises(TypeError):       # f32 activations
        quant.int8_attn_tail(a.float(), r, wo, so, g, w1, s1, w2, s2)
    with pytest.raises(TypeError):       # a weight that is not int8
        quant.int8_attn_tail(a, r, wo.to(torch.bfloat16), so, g, w1, s1, w2,
                             s2)
    with pytest.raises(ValueError):      # a non-contiguous weight
        quant.int8_attn_tail(a, r, wo.t(), so, g, w1, s1, w2, s2)
    with pytest.raises(ValueError):      # more than 32 rows
        big = _tail_args(gen, 33)
        quant.int8_attn_tail(*big)
    with pytest.raises(ValueError):      # D not a multiple of 128
        quant.int8_attn_tail(*_tail_args(gen, 4, hd=192, d=192, hid=256))


def _mk_args(gen, b, h, dh, L, nl, pos):
    d = h * dh
    (wq, sq), (wo, so) = _qk(gen, d, 3 * d), _qk(gen, d, d)
    shape = (b, nl, h, L, dh) if nl else (b, h, L, dh)
    kc, vc = _rnd(gen, *shape), _rnd(gen, *shape)
    kc[..., pos:, :] = 1e4    # garbage at and past pos
    vc[..., pos:, :] = 1e4
    bias = 0.1 * torch.randn(h, L, generator=gen, device="cuda")
    ln1 = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    return (_rnd(gen, b, d), kc, vc, pos, bias, ln1,
            torch.cat([wq, wo], dim=1).contiguous(), torch.cat([sq, so]))


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("pos", [0, 1, 100, 159])
def test_megakernel_matches_plain(gen, b, dh, pos):
    h, L, nl = 4, 160, 3
    args = _mk_args(gen, b, h, dh, L, nl, pos)
    before = mk.decode_attn_megakernel.launches
    outs = mk.decode_attn_megakernel(*args, layer=1)
    assert mk.decode_attn_megakernel.launches == before + 1
    refs = mk.decode_attn_megakernel_plain(*args, layer=1)
    for o, r in zip(outs, refs):
        assert bool(torch.isfinite(o.float()).all())
        _close(o, r)
    again = mk.decode_attn_megakernel(*args, layer=1)
    torch.cuda.synchronize()
    assert all(torch.equal(o, a) for o, a in zip(outs, again))


def test_megakernel_unstacked_cache_and_no_bias(gen):
    x, kc, vc, pos, bias, ln1, wqo, sqo = _mk_args(gen, 2, 4, 128, 96, 0, 40)
    # a bias wider than the cache (a row stride that is not L)
    wide = 0.1 * torch.randn(4, 128, generator=gen, device="cuda")
    for bias_col in (bias, None, wide):
        outs = mk.decode_attn_megakernel(x, kc, vc, pos, bias_col, ln1, wqo,
                                         sqo)
        refs = mk.decode_attn_megakernel_plain(x, kc, vc, pos, bias_col, ln1,
                                               wqo, sqo)
        for o, r in zip(outs, refs):
            _close(o, r)


def test_megakernel_refuses_what_the_kernel_does_not_take(gen):
    x, kc, vc, pos, bias, ln1, wqo, sqo = _mk_args(gen, 2, 4, 128, 96, 2, 40)
    with pytest.raises(TypeError):       # an int8 cache
        mk.decode_attn_megakernel(x, kc.to(torch.int8), vc.to(torch.int8),
                                  pos, bias, ln1, wqo, sqo, layer=0)
    with pytest.raises(TypeError):       # f32 activations
        mk.decode_attn_megakernel(x.float(), kc, vc, pos, bias, ln1, wqo,
                                  sqo, layer=0)
    with pytest.raises(ValueError):      # a cache that is a strided view
        mk.decode_attn_megakernel(x, kc[:, 0], vc[:, 0], pos, bias, ln1,
                                  wqo, sqo)
    with pytest.raises(ValueError):      # pos outside the cache
        mk.decode_attn_megakernel(x, kc, vc, 96, bias, ln1, wqo, sqo,
                                  layer=0)
    with pytest.raises(ValueError):      # more than 8 rows
        mk.decode_attn_megakernel(*_mk_args(gen, 9, 4, 128, 96, 2, 40),
                                  layer=0)
    with pytest.raises(ValueError):      # a head dim the kernel lacks
        mk.decode_attn_megakernel(*_mk_args(gen, 2, 8, 32, 96, 2, 40),
                                  layer=0)


# ── int8_matmul: the untied lm_head's product at decode ──────────────

def _head(gen, k, n):
    return quant.quantize_kernel(0.02 * torch.randn(k, n, generator=gen,
                                                    device="cuda"))


@pytest.mark.parametrize("n", [1, 130, 384, 32002])
@pytest.mark.parametrize("m", [1, 3, 8, 9, 17, 32])
def test_int8_matmul_matches_plain(gen, m, n):
    """Any N (32002: rows that are not 16-byte aligned, a guarded last
    block) and every M up to 32, at K = 256."""
    wq, scale = _head(gen, 256, n)
    x = _rnd(gen, m, 256)
    before = quant.int8_matmul.launches
    out = quant.int8_matmul(x, wq, scale)
    assert quant.int8_matmul.launches == before + 1
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    _close(out, quant.int8_matmul_plain(x, wq, scale))
    assert torch.equal(quant.int8_matmul(x, wq, scale), out)   # repeatable


@pytest.mark.parametrize("offset,width", [(0, 141), (7, 141), (16, 160),
                                          (3, 133)])
def test_int8_matmul_reads_a_strided_weight_in_place(gen, offset, width):
    """A view into a wider weight: any row stride, any first byte; the
    bytes around the view are poison the kernel must not use, and the view
    reaches the last byte of its storage when offset + 130 == width."""
    wide = torch.full((256, width), 127, dtype=torch.int8, device="cuda")
    wq, scale = _head(gen, 256, 130)
    view = wide[:, offset:offset + 130]
    view.copy_(wq)
    assert view.data_ptr() == wide.data_ptr() + offset
    x = _rnd(gen, 5, 256)
    _close(quant.int8_matmul(x, view, scale),
           quant.int8_matmul_plain(x, wq, scale))


def test_int8_matmul_takes_a_non_contiguous_x(gen):
    wq, scale = _head(gen, 256, 130)
    x = _rnd(gen, 256, 8).t()            # [8, 256], column-major
    assert not x.is_contiguous()
    _close(quant.int8_matmul(x, wq, scale),
           quant.int8_matmul_plain(x, wq, scale))


def test_int8_matmul_rows_do_not_depend_on_m(gen):
    """M = 3 runs the kernel that computes 8 rows at a time with 5 rows
    absent: its rows equal, bit for bit, those of the same x within an
    8-row call (one order of summation a row)."""
    wq, scale = _head(gen, 256, 130)
    x = _rnd(gen, 8, 256)
    out3 = quant.int8_matmul(x[:3], wq, scale)
    assert out3.shape == (3, 130)
    assert torch.equal(out3, quant.int8_matmul(x, wq, scale)[:3])


def test_int8_matmul_refuses_what_the_kernel_does_not_take(gen):
    wq, scale = _head(gen, 256, 130)
    x = _rnd(gen, 4, 256)
    with pytest.raises(TypeError):
        quant.int8_matmul(x.float(), wq, scale)
    with pytest.raises(TypeError):
        quant.int8_matmul(x, wq.to(torch.int16), scale)
    with pytest.raises(ValueError, match="M=33"):
        quant.int8_matmul(_rnd(gen, 33, 256), wq, scale)
    with pytest.raises(ValueError, match="K=96"):
        quant.int8_matmul(_rnd(gen, 4, 96), *_head(gen, 96, 130))
    with pytest.raises(ValueError, match="strides"):
        quant.int8_matmul(x, _head(gen, 130, 256)[0].t(), scale)
    for args in ((x.cpu(), wq, scale), (x, wq.cpu(), scale),
                 (x, wq, scale.cpu())):
        with pytest.raises(ValueError, match="on cpu"):
            quant.int8_matmul(*args)
    before = quant.int8_matmul.launches
    with pytest.raises(ValueError):
        quant.int8_matmul(x, wq, scale[:100])
    assert quant.int8_matmul.launches == before
