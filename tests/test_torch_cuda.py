"""The port's CUDA kernels against their plain versions on the card, over
the edge cases the serving and training paths' shapes do not reach (other
head dims, "ge" ids, full-rank and broadcast biases, rows that attend
nothing, lengths that are not multiples of the tile, odd batch sizes,
biases and other activations in the MLP, the fused decode layer's two
kernels at small widths, the megakernel captured once and replayed at
every position, the ends of the cache and refused inputs), the
continuous batcher's pooled step and speculative decoding (alone and in
the pool) on a small model, kernels against plain, and the captured
decode steps (the engine's greedy and beam steps, the megakernel route's,
the pool's, OtterHD's) against their eager steps.

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


def _close(out, ref, keep=None, slack=None):
    """`slack`: a tensor added to the bound (a rounding that the function
    itself does before a cancellation)."""
    torch.cuda.synchronize()
    d = (out.float() - ref.float()).abs()
    bound = 2e-2 + 2e-2 * ref.float().abs()
    if slack is not None:
        bound = bound + slack.float()
    if keep is not None:
        d, bound = d[keep], bound[keep]
    assert bool((d <= bound).all()), float(d.max())


def _close_rows(out, ref):
    """`_close` with the absolute 2e-2 scaled down to each row's (last
    dim's) largest |plain| where that is below 1: a long decode span
    averages its values down to ~0.03, where 2e-2 would pass a chunk that
    drops or repeats keys."""
    torch.cuda.synchronize()
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    bound = 2e-2 * r.amax(-1, keepdim=True).clamp(max=1) + 2e-2 * r
    assert bool((d <= bound).all()), float(d.max())


def _rnd(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
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


@pytest.mark.parametrize("d", [64, 128])
def test_flash_prefix_lm_ids_and_perceiver_frame_mask(gen, d):
    """The two id masks this port's decoder and perceiver add: prefix-LM
    ("ge", not causal, prefix keys id 0, the others their position, pad
    keys s + 1) under the symmetric ALiBi bias [1, H, S, S]; and the
    perceiver's frame mask ("eq": latents id 1 against padded frames' keys
    at id 0) with many more keys than queries."""
    from otter_tpu_torch.ops.masks import alibi_bias
    b, h, s = 2, 4, 75
    q, k, v = (_rnd(gen, b, h, s, d) for _ in range(3))
    pos = torch.arange(s, device="cuda")
    prefix = pos[None] < torch.tensor([[20], [41]], device="cuda")
    ok = torch.ones(b, s, dtype=torch.bool, device="cuda")
    ok[1, s - 5:] = False
    ki = torch.where(prefix & ok, 0, pos[None])
    ki = torch.where(ok, ki, s + 1).int()
    kw = dict(bias=alibi_bias(h, s, full=True, device="cuda"),
              q_ids=pos[None].expand(b, s).int(), kv_ids=ki, ids_mode="ge")
    _close(fa.flash_attention(q, k, v, **kw),
           fa.flash_attention_plain(q, k, v, **kw))
    sk = 3 * 64 + 16
    q, k, v = _rnd(gen, b, h, 16, d), _rnd(gen, b, h, sk, d), \
        _rnd(gen, b, h, sk, d)
    kv_ids = torch.ones(b, sk, dtype=torch.int32, device="cuda")
    kv_ids[0, 64:192] = 0
    kw = dict(q_ids=torch.ones(b, 16, dtype=torch.int32, device="cuda"),
              kv_ids=kv_ids, ids_mode="eq")
    _close(fa.flash_attention(q, k, v, **kw),
           fa.flash_attention_plain(q, k, v, **kw))


@pytest.mark.parametrize("flags", ["prefix_lm", "attn_uses_sequence_id",
                                   "both"])
def test_decoder_masks_through_the_kernel(gen, flags):
    """A small bf16 MPT decoder with the prefix-LM and sequence-id masks:
    the flash kernel's route (ids, or the materialised bias for both)
    against the plain attention route, logits within 5e-2 max|plain|."""
    from otter_tpu_torch import config as tcfg
    from otter_tpu_torch.models.decoder import Decoder
    on = {"both": dict(prefix_lm=True, attn_uses_sequence_id=True)}.get(
        flags, {flags: True})
    cfg = tcfg.TextConfig(vocab_size=256, hidden_size=256,
                          num_hidden_layers=2, num_attention_heads=2,
                          max_seq_len=128, **on)
    model = Decoder(cfg, dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=gen,
                                       device="cuda") + (name.endswith(
                                           "scale")))
    b, s = 2, 96
    ids = torch.randint(0, 256, (b, s), generator=gen, device="cuda")
    kw = dict(attention_mask=torch.ones(b, s, dtype=torch.int32,
                                        device="cuda"))
    kw["attention_mask"][1, s - 7:] = 0
    if cfg.prefix_lm:
        kw["prefix_mask"] = torch.arange(s, device="cuda")[None] < \
            torch.tensor([[30], [50]], device="cuda")
    if cfg.attn_uses_sequence_id:
        kw["sequence_id"] = (torch.arange(s, device="cuda")[None] // 40
                             ).expand(b, s).int()
    before = fa.flash_attention.launches
    with torch.no_grad():
        out, _ = model(ids, **kw)
        saved = attention.default_impl
        attention.default_impl = lambda q: "ref"
        try:
            ref, _ = model(ids, **kw)
        finally:
            attention.default_impl = saved
    assert fa.flash_attention.launches == before + 2
    keep = kw["attention_mask"].bool()
    err = float((out.float() - ref.float()).abs()[keep].max())
    assert err <= 5e-2 * float(ref.float().abs().max()), err


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


@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
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


@pytest.mark.parametrize("d", [16, 64, 96])
def test_flash_backward_full_bias_unequal_lengths(gen, d):
    b, h, sq, sk = 2, 2, 70, 131
    q, k, v = _rnd(gen, b, h, sq, d), _rnd(gen, b, h, sk, d), \
        _rnd(gen, b, h, sk, d)
    bias = torch.randn(b, h, sq, sk, generator=gen, device="cuda")
    kern, plain = _backward_pair(gen, q, k, v, dict(bias=bias))
    for a, r in zip(kern, plain):
        _close_grad(a, r)


@pytest.mark.parametrize("mode", ["eq", "ge"])
@pytest.mark.parametrize("d", [32, 80, 112, 128])
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


def _dq_case(gen, d, case):
    """(q, k, v, kwargs) of one dQ case: S_q crosses the 128-query tile and
    leaves a warpgroup partly past the rows."""
    b, h = 2, 3
    if case == "row_bias_causal_ids":
        s_q = s_k = 200
        kw = dict(bias=(torch.arange(1 - s_k, 1, device="cuda")
                        [None, None, None, :]
                        * torch.rand(1, h, 1, 1, generator=gen,
                                     device="cuda")), causal=True)
        ids = torch.ones(b, s_q, dtype=torch.int32, device="cuda")
        ids[1, 150:] = 0
        kw.update(q_ids=ids, kv_ids=ids)
    elif case == "full_bias_ragged":
        s_q, s_k = 150, 77
        kw = dict(bias=torch.randn(b, 1, s_q, s_k, generator=gen,
                                   device="cuda"))
    else:   # eq / ge media ids; q id 0 attends no key (dead rows)
        s_q, s_k = 140, 70
        q_ids = torch.randint(0, 3, (b, s_q), generator=gen, device="cuda",
                              dtype=torch.int32)
        q_ids[:, :5] = 0
        kv_ids = torch.arange(1, 3, device="cuda", dtype=torch.int32
                              ).repeat_interleave(35)[None].expand(b, s_k)
        kw = dict(q_ids=q_ids, kv_ids=kv_ids, ids_mode=case[:2])
    return (_rnd(gen, b, h, s_q, d), _rnd(gen, b, h, s_k, d),
            _rnd(gen, b, h, s_k, d), kw)


@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("case", ["row_bias_causal_ids", "full_bias_ragged",
                                  "eq_dead_rows", "ge_dead_rows"])
def test_flash_dq_matches_plain(gen, d, case):
    """The dQ kernel alone against the plain backward's dq, from the plain
    forward's lse: every head dim, row and full bias, eq and ge ids,
    causal, ragged S, rows that attend no key (their dq is 0)."""
    q, k, v, kw = _dq_case(gen, d, case)
    args = (q, k, v, kw.get("bias"), kw.get("q_ids"), kw.get("kv_ids"))
    opts = {n: kw[n] for n in ("causal", "ids_mode") if n in kw}
    out, lse = fa.flash_attention_plain(*args, return_lse=True, **opts)
    do = _rnd(gen, *out.shape)
    di = (out.float() * do.float()).sum(-1)
    before = fa.flash_bwd_dq.launches
    dq = fa.flash_bwd_dq(*args, lse, di, do, **opts)
    assert fa.flash_bwd_dq.launches == before + 1
    ref = fa.flash_attention_bwd_plain(*args, out, lse, do, **opts)[0]
    _close_grad(dq, ref)
    if case.endswith("dead_rows"):
        assert bool((dq[:, :, :5] == 0).all())


@pytest.mark.parametrize("d", [72, 136])
def test_flash_refuses_head_dims_off_the_k16_grid(gen, d):
    q = _rnd(gen, 1, 2, 40, d)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention(*(q[..., :64].float() for _ in range(3)))


def test_flash_unaligned_views(gen):
    """q/k/v views that start off a 16-byte boundary are copied, not read
    misaligned."""
    base = _rnd(gen, 2 * 3 * 50 * 80 + 1)
    q = base[1:].view(2, 3, 50, 80)
    assert q.data_ptr() % 16
    _close(fa.flash_attention(q, q, q, causal=True),
           fa.flash_attention_plain(q, q, q, causal=True))


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


def _every_int8(gen, rows):
    """[rows, 256] int8: each row holds all 256 values, in its own order."""
    vals = torch.arange(-128, 128, device="cuda")
    return torch.stack([vals[torch.randperm(256, generator=gen,
                                            device="cuda")]
                        for _ in range(rows)]).to(torch.int8)


@pytest.mark.parametrize("phase", [1, 2])
def test_int8_mlp_converts_every_int8_exactly(gen, phase):
    # 32 one-hot rows of x pick 32 rows of a weight whose rows hold all 256
    # int8 values; the other product is the identity (W2 = 127 I scaled by
    # 1/127 in phase 1, W1 = I in phase 2), and b1 = 128 (phase 1) keeps
    # the hidden values 0..255 above relu's zero. Every sum has one nonzero
    # term, so kernel and plain version agree bit for bit, and a weight
    # converted wrongly shows as itself.
    m = 32
    pick = torch.randperm(256, generator=gen, device="cuda")[:m]
    x = torch.zeros(m, 256, device="cuda", dtype=torch.bfloat16)
    x[torch.arange(m, device="cuda"), pick] = 1
    ones = torch.ones(256, device="cuda")
    eye = torch.eye(256, device="cuda", dtype=torch.int8)
    if phase == 1:
        w1q, s1, b1 = _every_int8(gen, 256), ones, 128 * ones
        w2q, s2 = 127 * eye, ones / 127
        want = w1q[pick].float() + 128
    else:
        w1q, s1, b1 = eye, ones, None
        w2q, s2 = _every_int8(gen, 256), ones
        want = w2q[pick].float()
    kw = dict(act="relu", b1=b1)
    out = quant.int8_mlp(x, w1q, s1, w2q, s2, **kw)
    ref = quant.int8_mlp_plain(x, w1q, s1, w2q, s2, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert torch.equal(out, want.to(torch.bfloat16))


@pytest.mark.parametrize("m", [20, 32])
def test_int8_mlp_ragged_output_and_k(gen, m):
    # N = 4112 leaves a last column stage of 16; K = 320 a last row stage
    # of 64
    w1q, s1 = quant.quantize_kernel(0.05 * torch.randn(
        320, 384, generator=gen, device="cuda"))
    w2q, s2 = quant.quantize_kernel(0.05 * torch.randn(
        384, 4112, generator=gen, device="cuda"))
    x = _rnd(gen, m, 320)
    out = quant.int8_mlp(x, w1q, s1, w2q, s2)
    _close(out, quant.int8_mlp_plain(x, w1q, s1, w2q, s2))
    assert torch.equal(quant.int8_mlp(x, w1q, s1, w2q, s2), out)


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


def _decode_cache(gen, cache, b, nl, h, L, d):
    """(k, v, scale kwargs) of a cache of one of the three kinds."""
    if cache == "int4":
        kv, ks, vs = _int4_cache(gen, b, nl, h, L, d)
        return kv, kv, dict(k_scale=ks, v_scale=vs, kv_bits=4)
    k, v = _rnd(gen, b, nl, h, L, d), _rnd(gen, b, nl, h, L, d)
    if cache == "bf16":
        return k, v, {}
    (k, ks), (v, vs) = quant.quantize_kv(k), quant.quantize_kv(v)
    return k, v, dict(k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,L", [(1, 2400), (8, 256)])
def test_decode_attention_split_matches_plain(gen, cache, d, b, L):
    """The split kernel at the long cache of OtterHD (b=1, L=2400: many
    chunks a row) and at MPT's serving cache (b=8, L=256: few), ragged
    starts and lengths, one row whose span is one position; two calls give
    the same bits."""
    nl, h = 2, 16
    q = _rnd(gen, b, h, d)
    k, v, kw = _decode_cache(gen, cache, b, nl, h, L, d)
    starts = torch.tensor([0, 7, 100, 0, 31, 64, 5, 200][:b], device="cuda")
    lengths = torch.tensor([L - 28, L, 101, L - 1, 150, L, 99, L - 3][:b],
                           device="cuda")
    bias = torch.randn(b, 1, L, generator=gen, device="cuda")
    splits, _ = da.split_plan(b, h, L, d, {"bf16": 0, "int8": 1,
                                           "int4": 2}[cache])
    assert splits > 1 or b == 8
    out = da.decode_attention(q, k, v, lengths, bias, starts, layer=1, **kw)
    again = da.decode_attention(q, k, v, lengths, bias, starts, layer=1,
                                **kw)
    ref = da.decode_attention_plain(q, k, v, lengths, bias, starts, layer=1,
                                    **kw)
    _close_rows(out, ref)
    assert torch.equal(out, again)


def _int4_pair(gen, k, h, n):
    w1p, s1 = quant.quantize_kernel_int4(0.05 * torch.randn(
        k, h, generator=gen, device="cuda"), 0)
    w2p, s2 = quant.quantize_kernel_int4(0.05 * torch.randn(
        h, n, generator=gen, device="cuda"), 1)
    return w1p, s1, w2p, s2


@pytest.mark.parametrize("m", [1, 5, 8, 20, 32])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
def test_int4_mlp_matches_plain(gen, m, act):
    # N/2 = 96: a stage narrower than its 256 packed columns
    w = _int4_pair(gen, 256, 512, 192)
    x = _rnd(gen, m, 256)
    before = quant.int4_mlp.launches
    out = quant.int4_mlp(x, *w, act=act)
    assert quant.int4_mlp.launches == before + 1
    _close(out, quant.int4_mlp_plain(x, *w, act=act))


def test_int4_mlp_wide_output_and_determinism(gen):
    # N/2 = 2560: ten 256-column stages of packed W2
    w = _int4_pair(gen, 1024, 2048, 5120)
    x = _rnd(gen, 8, 1024)
    first = quant.int4_mlp(x, *w)
    _close(first, quant.int4_mlp_plain(x, *w))
    for _ in range(3):
        assert torch.equal(quant.int4_mlp(x, *w), first)


@pytest.mark.parametrize("m", [1, 7, 8, 9, 17, 32])
def test_int4_mlp_every_n_tile_count(gen, m):
    # 1 to 4 n-tiles of 8 rows; K = 96: 48 packed rows, less than one
    # stage (the rest zero-filled), not a multiple of 128; N/2 = 160 packed
    # columns, part of one phase-2 stage
    w = _int4_pair(gen, 96, 256, 320)
    x = _rnd(gen, m, 96)
    out = quant.int4_mlp(x, *w)
    _close(out, quant.int4_mlp_plain(x, *w))
    assert torch.equal(quant.int4_mlp(x, *w), out)   # sums in a fixed order


@pytest.mark.parametrize("m", [1, 8, 32])
def test_int4_mlp_falcon7b_k(gen, m):
    # K = 4544 (falcon7b's hidden size, not a multiple of 128): 2272 packed
    # rows, a ragged last stage at every n-tile count
    w = _int4_pair(gen, 4544, 256, 4544)
    x = _rnd(gen, m, 4544)
    out = quant.int4_mlp(x, *w)
    _close(out, quant.int4_mlp_plain(x, *w))
    assert torch.equal(quant.int4_mlp(x, *w), out)


@pytest.mark.parametrize("m", [1, 32])
def test_int4_mlp_grid_beyond_the_sm_count(gen, m):
    # H / 128 CTAs > the SMs: the two-CTAs-an-SM variant
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    w = _int4_pair(gen, 64, 128 * (sms + 10), 96)
    x = _rnd(gen, m, 64)
    out = quant.int4_mlp(x, *w)
    _close(out, quant.int4_mlp_plain(x, *w))
    assert torch.equal(quant.int4_mlp(x, *w), out)


def test_int4_mlp_refuses_k_not_multiple_of_32(gen):
    w = _int4_pair(gen, 80, 128, 64)
    with pytest.raises(ValueError, match="K=80"):
        quant.int4_mlp(_rnd(gen, 2, 80), *w)


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


@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("n", [12288, 4096])
def test_int4_matmul_at_mpt7b_widths(gen, m, n):
    """MPT-7B's qkv (N = 12288) and out-projection (N = 4096) at K = 4096,
    split over the packed rows: matches the plain version, and two calls
    agree bit for bit (the partial sums are added in a fixed order)."""
    wp, scale = quant.quantize_kernel_int4(0.02 * torch.randn(
        4096, n, generator=gen, device="cuda"), 0)
    x = _rnd(gen, m, 4096)
    out = quant.int4_matmul(x, wp, scale)
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

def _qk(gen, rows, cols, std=0.05):
    return quant.quantize_kernel(std * torch.randn(
        rows, cols, generator=gen, device="cuda"))


def _tail_args(gen, m, hd=256, d=256, hid=512, std=0.05):
    (wo, so), (w1, s1), (w2, s2) = _qk(gen, hd, d, std), \
        _qk(gen, d, hid, std), _qk(gen, hid, d, std)
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


def test_attn_tail_full_width_m32(gen):
    # MPT-7B's widths at the largest M: W1 and W2 (134 MB) stream once.
    # Weights of std 0.02, as a model's init (and chip_smoke.py's case).
    # The function rounds the MLP's output (up to |~50|) to bf16 before the
    # residual, which may bring the result near 0: one bf16 step of that
    # output (2^-7 |mlp|, 0.25 at 50) is allowed beside the tolerance.
    args = _tail_args(gen, 32, hd=4096, d=4096, hid=16384, std=0.02)
    out = quant.int8_attn_tail(*args)
    ref, mlp = quant.int8_attn_tail_plain(*args, return_mlp=True)
    _close(out, ref, slack=2.0 ** -7 * mlp.float().abs())
    again = quant.int8_attn_tail(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.parametrize("m", [1, 8, 9, 16, 17, 32])
def test_attn_tail_every_n_tile_count(gen, m):
    # 1 to 4 n-tiles of 8 rows in the out-projection's product; its K of
    # 320 rows is two and a half 128-row stages (the last half zero-filled)
    args = _tail_args(gen, m, hd=320, d=512, hid=640)
    out = quant.int8_attn_tail(*args)
    _close(out, quant.int8_attn_tail_plain(*args))
    again = quant.int8_attn_tail(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


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


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("dh", [64, 128])
def test_megakernel_long_span_split_over_ctas(gen, b, dh):
    # a span of 2047 rows over few heads: the attention phase cuts it into
    # chunks on many CTAs and merges them in chunk order. The bias lifts a
    # few keys far apart, so that the output depends on the weights the
    # merge gives chunks that hold them (a flat softmax would average any
    # error away).
    h, L, nl, pos = 4, 2048, 2, 2047
    args = list(_mk_args(gen, b, h, dh, L, nl, pos))
    args[4][:, 5:9] += 6.0
    args[4][:, 1000:1010] += 7.0
    args[4][:, 2040:2046] += 6.5
    outs = mk.decode_attn_megakernel(*args, layer=1)
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


def _captured(fn, ws):
    """(graph, outputs) of `fn` captured on a side stream with `ws` as the
    decode_attention workspace it owns (an eager call first sizes it), and
    the launches the capture recorded."""
    from otter_tpu_torch import _build
    side, main = torch.cuda.Stream(), torch.cuda.current_stream()
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), da.owned_workspace(ws):
        fn()
        ws.frozen = True
        with _build.recording_launches() as launches:
            graph.capture_begin()
            out = fn()
            graph.capture_end()
    main.wait_stream(side)
    return graph, out, launches


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_megakernel_graph_replays_at_every_position(gen, dtype):
    """The position in device memory: one capture at pos 0, then the
    counter moved and the graph replayed at positions from 1 to L - 1
    (one CTA up to many chunks a head), each replay held to the plain
    version at its own position; the capture recorded one launch."""
    b, h, dh, L, nl = 3, 4, 128, 512, 2
    x, kc, vc, _, bias, ln1, wqo, sqo = _mk_args(gen, b, h, dh, L, nl, L)
    pos = torch.zeros((), dtype=dtype, device="cuda")
    graph, outs, launches = _captured(
        lambda: mk.decode_attn_megakernel(x, kc, vc, pos, bias, ln1, wqo,
                                          sqo, layer=1), da.Workspace())
    assert launches == {(mk.decode_attn_megakernel, False): 1}
    for p in (0, 1, 57, 300, L - 1):
        pos.fill_(p)
        graph.replay()
        refs = mk.decode_attn_megakernel_plain(x, kc, vc, p, bias, ln1, wqo,
                                               sqo, layer=1)
        for o, r in zip(outs, refs):
            _close(o, r)
        eager = mk.decode_attn_megakernel(x, kc, vc, p, bias, ln1, wqo, sqo,
                                          layer=1)
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(outs, eager))


def test_a_larger_call_leaves_the_megakernels_owned_workspace_alone(gen):
    """A captured megakernel call owns its workspace: a larger eager call
    (8 rows over a cache of 2048: a workspace of more chunks) grows the
    shared pair, the owned pair stays the same tensors, and the graph's
    replays still equal the plain version."""
    x, kc, vc, _, bias, ln1, wqo, sqo = _mk_args(gen, 2, 4, 128, 512, 2, 512)
    pos = torch.tensor(300, device="cuda")
    ws = da.Workspace()
    graph, outs, _ = _captured(
        lambda: mk.decode_attn_megakernel(x, kc, vc, pos, bias, ln1, wqo,
                                          sqo, layer=0), ws)
    held = ws.tensors()
    (part, cnt), = held.values()
    big = _mk_args(gen, 8, 4, 128, 2048, 2, 2047)
    mk.decode_attn_megakernel(*big, layer=1)
    shared = da._shared.tensors()[torch.cuda.current_device()][0]
    assert shared.numel() > part.numel()
    assert shared.data_ptr() != part.data_ptr()
    assert ws.tensors() == held
    for p in (299, 511):
        pos.fill_(p)
        graph.replay()
        refs = mk.decode_attn_megakernel_plain(x, kc, vc, p, bias, ln1, wqo,
                                               sqo, layer=0)
        for o, r in zip(outs, refs):
            _close(o, r)
    assert int(cnt.abs().sum()) == 0     # the counters left at 0


def test_megakernel_traps_on_a_device_position_outside_the_cache(gen):
    """A host int outside the cache is refused on the host; a device
    position outside it traps in the kernel (the launch fails, the
    process's context with it: so in a process of its own), where a
    clamp would have answered quietly."""
    import os
    import subprocess
    import sys
    x, kc, vc, pos, bias, ln1, wqo, sqo = _mk_args(gen, 2, 4, 128, 96, 2, 40)
    with pytest.raises(ValueError, match="outside"):
        mk.decode_attn_megakernel(x, kc, vc, 96, bias, ln1, wqo, sqo,
                                  layer=0)
    code = (
        "import torch\n"
        "from otter_tpu_torch.ops import megakernel as mk\n"
        "from otter_tpu_torch.ops import quant\n"
        "d = 512\n"
        "w, s = quant.quantize_kernel(0.05 * torch.randn(d, 4 * d, "
        "device='cuda'))\n"
        "kc = torch.randn(2, 2, 4, 96, 128, device='cuda', "
        "dtype=torch.bfloat16)\n"
        "x = torch.randn(2, d, device='cuda', dtype=torch.bfloat16)\n"
        "mk.decode_attn_megakernel(x, kc, kc.clone(), torch.tensor(96, "
        "device='cuda'), None, torch.ones(d, device='cuda'), w, s, "
        "layer=0)\n"
        "torch.cuda.synchronize()\n"
        "print('no trap')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode != 0 and "no trap" not in res.stdout, res.stdout
    assert "CUDA" in res.stderr, res.stderr[-2000:]


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


@pytest.mark.parametrize("m", [1, 8, 9, 32])
def test_int8_matmul_at_llama_head(gen, m):
    """LLaMA-2's head: K = 4096, N = ldw = 32002 (a row starts 16-byte
    aligned only every 8th row; a last block of 2 columns)."""
    wq, scale = _head(gen, 4096, 32002)
    x = _rnd(gen, m, 4096)
    out = quant.int8_matmul(x, wq, scale)
    _close(out, quant.int8_matmul_plain(x, wq, scale))
    assert torch.equal(quant.int8_matmul(x, wq, scale), out)


def test_int8_matmul_grid_of_several_waves(gen):
    """547 column blocks, more than the CTAs the card holds at once, with
    unaligned rows."""
    wq, scale = _head(gen, 256, 70001)
    x = _rnd(gen, 5, 256)
    out = quant.int8_matmul(x, wq, scale)
    _close(out, quant.int8_matmul_plain(x, wq, scale))
    assert torch.equal(quant.int8_matmul(x, wq, scale), out)


@pytest.mark.parametrize("m", [8, 16, 24])
def test_int8_matmul_n_tile_edges(gen, m):
    """M and M + 1 run with different numbers of n-tiles: each matches the
    plain version, and the M rows agree bit for bit (a row's order of
    summation does not depend on M)."""
    wq, scale = _head(gen, 512, 1000)
    x = _rnd(gen, m + 1, 512)
    small = quant.int8_matmul(x[:m], wq, scale)
    large = quant.int8_matmul(x, wq, scale)
    _close(small, quant.int8_matmul_plain(x[:m], wq, scale))
    _close(large, quant.int8_matmul_plain(x, wq, scale))
    assert torch.equal(large[:m], small)


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


def test_degrade_budget_ignores_freed_blocks(gen):
    """Two equal requests around a large freed tensor pick the same KV
    cache dtype: torch's caching allocator keeps the freed block, so the
    card's free memory drops by it, but the budget counts live tensors
    only."""
    from otter_tpu_torch import config
    from otter_tpu_torch.generation import engine
    text = config.otter_mpt7b().text
    dev = torch.device("cuda")
    b, cache_len = 8, 2048
    need = engine.cache_bytes(text, b, cache_len, torch.bfloat16)
    total = torch.cuda.mem_get_info(dev)[1]
    # a headroom that leaves the bf16 cache 1 GB to spare
    headroom = total - torch.cuda.memory_allocated(dev) - need - 1e9
    pick = lambda: engine.select_cache_dtype(
        text, b, cache_len, torch.bfloat16, device=dev,
        headroom_bytes=headroom)
    first = pick()
    big = torch.empty(int(4e9), dtype=torch.uint8, device=dev)
    del big
    assert torch.cuda.memory_reserved(dev) - \
        torch.cuda.memory_allocated(dev) >= 4e9
    assert pick() == first == torch.bfloat16
    torch.cuda.empty_cache()


# ── the continuous batcher on the card ───────────────────────────────

def _card_otter():
    """A small OtterVLM on the card with seeded random weights: int8
    decoder and xattn, head dim 64, MLP widths the int8 kernels take."""
    from otter_tpu_torch.config import (OtterConfig, PerceiverConfig,
                                        TextConfig, VisionConfig)
    from otter_tpu_torch.tools.random_weights import build_model
    cfg = OtterConfig(
        vision=VisionConfig(hidden_size=128, intermediate_size=256,
                            num_hidden_layers=1, num_attention_heads=2,
                            image_size=28, patch_size=14),
        text=TextConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=1024,
                        max_seq_len=512, quant="int8", decode_kernel="auto"),
        perceiver=PerceiverConfig(dim=128, depth=1, dim_head=64, heads=2,
                                  num_latents=8),
        cross_attn_every_n_layers=2, xattn_dim_head=64, xattn_heads=4,
        media_token_id=509, eoc_token_id=508)
    return build_model(cfg, "cuda", 0)


def _card_requests(gen, lengths):
    """(vision_x, ids) of one request a length, the media token first."""
    out = []
    for s in lengths:
        ids = torch.randint(1, 500, (1, s), generator=gen, device="cuda")
        ids[0, 0] = 509
        vx = torch.randn((1, 1, 1, 3, 28, 28), generator=gen, device="cuda")
        out.append((vx.cpu().numpy(), ids.cpu().numpy()))
    return out


def test_batcher_pooled_step_kernels_match_plain(gen, monkeypatch):
    """Three requests through a pool of 4 on the card, then one more
    pooled step over the pool they left: `int8_mlp` and `decode_attention`
    launched once a layer (whatever rows are active), the logits within
    5e-2 max|plain| of the same step with both swapped for their plain
    versions."""
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation.batching import ContinuousBatcher
    from otter_tpu_torch.tools import bench_decode
    model = _card_otter()
    reqs = _card_requests(gen, (9, 12, 15))
    b = ContinuousBatcher(model, num_slots=4, cache_len=64, buckets=(16,),
                          cache_dtype=torch.int8, max_admits_per_iter=4)
    try:
        got = [list(b.submit(vx, ids, Gen(max_new_tokens=6,
                                          eos_token_id=-1)))
               for vx, ids in reqs]
    finally:
        b.shutdown()
    assert b._failure is None and [len(g) for g in got] == [6, 6, 6]
    b._load_slot_state(b._slots)
    lp, st = b._lp_list, b._statics
    b._carried["alive"].copy_(torch.tensor([True, True, True, False]))
    # (the step advances the carried state in place: each run its copy)
    carried = lambda: {k: v.clone() for k, v in b._carried.items()}
    saved = ({k: v.clone() for k, v in b._cache.items()}, b._buffer.clone(),
             b._valid.clone())
    before = bench_decode.kernel_launches()
    kern = b._decode_step(carried(), st, lp, True)[4].float()
    torch.cuda.synchronize()
    after = bench_decode.kernel_launches()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"int8_mlp": 3,
                                          "decode_attention": 2}
    b._cache, b._buffer, b._valid = saved
    monkeypatch.setattr(da, "decode_attention", da.decode_attention_plain)
    monkeypatch.setattr(quant, "int8_mlp", quant.int8_mlp_plain)
    plain = b._decode_step(carried(), st, lp, True)[4].float()
    err = (kern[:3] - plain[:3]).abs().max().item()
    assert err <= 5e-2 * plain[:3].abs().max().item(), err


def test_batcher_finished_row_at_the_cache_end_on_the_card(gen):
    """A request that fills its row of the cache stops there while
    another decodes on: no write past the cache (which would be a
    device-side assert for every stream), the other request finishes."""
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation.batching import ContinuousBatcher
    model = _card_otter()
    reqs = _card_requests(gen, (10, 14))
    b = ContinuousBatcher(model, num_slots=2, cache_len=20, buckets=(16,),
                          cache_dtype=torch.int8, max_admits_per_iter=2)
    try:
        short = b.submit(*reqs[0], Gen(max_new_tokens=10, eos_token_id=-1))
        long_ = b.submit(*reqs[1], Gen(max_new_tokens=9, eos_token_id=-1))
        got = [list(short), list(long_)]
    finally:
        b.shutdown()
    torch.cuda.synchronize()
    assert b._failure is None and [len(g) for g in got] == [5, 5]


# ── speculative decoding on the card ─────────────────────────────────

def _card_draft():
    """A one-layer mosaic_gpt draft (qk_ln, an xattn block before it) of
    `_card_otter`'s vocabulary on the card, int8, seeded."""
    from otter_tpu_torch.tools.random_weights import build_model
    cfg = _card_otter().cfg
    cfg = cfg.replace(text=cfg.text.replace(
        arch="mosaic_gpt", qk_ln=True, num_hidden_layers=1),
        cross_attn_every_n_layers=1)
    return build_model(cfg, "cuda", 1)


def _launch_diff(fn):
    from otter_tpu_torch.tools import bench_decode
    before = bench_decode.kernel_launches()
    out = fn()
    torch.cuda.synchronize()
    after = bench_decode.kernel_launches()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def test_speculative_generator_kernels_match_plain(gen, monkeypatch):
    """`SpeculativeGenerator` at b=1 on the card, gamma 3: every round
    launches `int8_mlp` for the draft's opener (M = 2) and steps (M = 1)
    and the target's verify window (M = 4), `decode_attention` for the
    draft's steps; the tokens equal those with both kernels swapped for
    their plain versions, and `stream` gives them too."""
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation.speculative import SpeculativeGenerator
    model, draft = _card_otter(), _card_draft()
    vx, ids = _card_requests(gen, (13,))[0]
    # (eager: the counting wrapper runs a round at a time)
    sg = SpeculativeGenerator(model, draft, gamma=3, cache_dtype=torch.int8,
                              cuda_graph=False)
    rounds, rnd = [], sg._round_body

    def counted(*a, **k):
        out, launched = _launch_diff(lambda: rnd(*a, **k))
        rounds.append(launched)
        return out

    sg._round_body = counted
    g = Gen(max_new_tokens=10, eos_token_id=-1)
    kern = sg.generate(vx, ids, gen=g)
    assert rounds and all(r == {"int8_mlp": 2 + 2 * 2 + 3,
                                "decode_attention": 2 * 1}
                          for r in rounds), rounds
    sg._round_body = rnd
    assert list(sg.stream(vx, ids, gen=g)) == kern[0, 13:].tolist()
    monkeypatch.setattr(da, "decode_attention", da.decode_attention_plain)
    monkeypatch.setattr(quant, "int8_mlp", quant.int8_mlp_plain)
    plain = sg.generate(vx, ids, gen=g)
    assert kern.tolist() == plain.tolist()


def test_spec_pool_kernels_match_plain(gen, monkeypatch):
    """Three requests through a pool of 4 with the draft (gamma 2) on the
    card: every round launches `int8_mlp` for the opener (M = 8), the step
    (M = 4) and the verify window (M = 12) and `decode_attention` for the
    step; the tokens equal the pool's with both kernels swapped for their
    plain versions."""
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation.batching import ContinuousBatcher
    model, draft = _card_otter(), _card_draft()
    reqs = _card_requests(gen, (9, 12, 15))

    def run(count: bool):
        # (eager: the counting wrapper runs a round at a time)
        b = ContinuousBatcher(model, num_slots=4, cache_len=64,
                              buckets=(16,), cache_dtype=torch.int8,
                              max_admits_per_iter=4, draft=draft,
                              spec_gamma=2, spec_adaptive=False,
                              cuda_graph=False)
        launched, rnd = [], b._spec_round

        def counted(*a):
            out, n = _launch_diff(lambda: rnd(*a))
            launched.append(n)
            return out

        if count:   # (the plain versions carry no launch counters)
            b._spec_round = counted
        try:
            got = [list(b.submit(vx, ids, Gen(max_new_tokens=7,
                                              eos_token_id=-1)))
                   for vx, ids in reqs]
        finally:
            b.shutdown()
        assert b._failure is None
        return got, launched

    kern, launched = run(True)
    assert launched and all(r == {"int8_mlp": 2 + 2 + 3,
                                  "decode_attention": 1}
                            for r in launched), launched
    monkeypatch.setattr(da, "decode_attention", da.decode_attention_plain)
    monkeypatch.setattr(quant, "int8_mlp", quant.int8_mlp_plain)
    assert [len(g) for g in kern] == [7, 7, 7] and run(False)[0] == kern


def test_spec_row_at_the_cache_end_on_the_card(gen):
    """A pool row that stops within gamma+1 columns of the cache's end
    steps on, dead, while another request decodes: no round writes past
    the cache (a device-side assert for every stream)."""
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation.batching import ContinuousBatcher
    model, draft = _card_otter(), _card_draft()
    reqs = _card_requests(gen, (10, 14))
    b = ContinuousBatcher(model, num_slots=2, cache_len=24, buckets=(16,),
                          cache_dtype=torch.int8, draft=draft, spec_gamma=3,
                          spec_adaptive=False)
    try:
        first = list(b.submit(*reqs[0], Gen(max_new_tokens=20,
                                            eos_token_id=-1)))
        second = list(b.submit(*reqs[1], Gen(max_new_tokens=4,
                                             eos_token_id=-1)))
    finally:
        b.shutdown()
    torch.cuda.synchronize()
    assert b._failure is None
    assert 6 <= len(first) <= 9 and len(second) == 4


# ── the captured decode step ─────────────────────────────────────────

def _graph_batch(gen, rows, length=14):
    """(vision_x, ids) of `rows` requests of `length` tokens, stacked."""
    import numpy as np
    reqs = _card_requests(gen, (length,) * rows)
    return (np.concatenate([r[0] for r in reqs]),
            np.concatenate([r[1] for r in reqs]))


def test_graphed_generate_equals_eager_with_its_launches(gen):
    """`OtterGenerator` on the card captures its step by default: the
    first request of a key runs a step eagerly, captures, then replays;
    a later one only replays. Tokens and every kernel's launches equal
    the eager step's (`cuda_graph=False`), the stream yields the same
    tokens, and replays make no host sync."""
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.tools import bench_decode
    model = _card_otter()
    vx, ids = _graph_batch(gen, 3)
    g = Gen(max_new_tokens=12, eos_token_id=-1)
    eager = OtterGenerator(model, cache_dtype=torch.int8, cuda_graph=False)
    graphed = OtterGenerator(model, cache_dtype=torch.int8)
    assert graphed.cuda_graph and not eager.cuda_graph

    def run(engine, rows=3):
        before = bench_decode.kernel_launches()
        out = engine.generate(vx[:rows], ids[:rows], gen=g)
        after = bench_decode.kernel_launches()
        return out, {k: after[k] - before[k] for k in after}

    want, want_n = run(eager)
    assert want_n["decode_attention"] == 11 * 2
    for _ in range(2):      # capture, then replays only
        got, got_n = run(graphed)
        assert (got == want).all() and got_n == want_n
    entry = graphed._entries[-1]
    assert entry.graph is not None and entry.capture_ms > 0
    assert sum(entry.launches.values()) > 0
    streamed = list(graphed.stream_generate(vx[:1], ids[:1], gen=g))
    assert streamed == run(eager, 1)[0][0, ids.shape[1]:].tolist()
    # a key with bans (no-repeat n-grams, bad words): their prefixes are
    # made once, outside the capture
    bans = Gen(max_new_tokens=12, eos_token_id=-1, no_repeat_ngram_size=2,
               bad_words_ids=((int(want[0, 15]), int(want[0, 16])),
                              (int(want[1, 17]),)))
    for _ in range(2):
        assert (graphed.generate(vx, ids, gen=bans)
                == eager.generate(vx, ids, gen=bans)).all()
    st = graphed._prefill(vx, ids, None, g)
    try:
        graphed._advance(st)    # a replay of the captured key
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(4):
                graphed._advance(st)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finally:
        graphed._finish(st)


def test_sampled_graphed_request_repeats_by_seed(gen):
    """The request's generator is copied into the one the graph
    registered: one seed gives one answer, graphed or eager."""
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation.engine import OtterGenerator
    model = _card_otter()
    vx, ids = _graph_batch(gen, 2)
    g = Gen(max_new_tokens=10, do_sample=True, temperature=1.5, top_k=50,
            top_p=0.95, eos_token_id=-1)
    seeded = lambda: torch.Generator(device="cuda").manual_seed(7)
    graphed = OtterGenerator(model, cache_dtype=torch.int8)
    outs = [graphed.generate(vx, ids, gen=g, generator=seeded())
            for _ in range(3)]
    assert graphed._entries[-1].graph is not None
    eager = OtterGenerator(model, cache_dtype=torch.int8, cuda_graph=False)
    assert (outs[0] == outs[1]).all() and (outs[1] == outs[2]).all()
    assert (eager.generate(vx, ids, gen=g, generator=seeded())
            == outs[0]).all()


def test_megakernel_route_refuses_a_graph(gen):
    """(The name is from when the route's kernel took its position by
    value and the engine refused to capture it.) The megakernel route's
    step is captured by default: its kernel reads the position from the
    device counter. Tokens and launches equal the eager step's, the
    megakernel once a layer a step, and a replay makes no host sync."""
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.tools.random_weights import build_model
    cfg = _card_otter().cfg
    model = build_model(cfg.replace(text=cfg.text.replace(
        megakernel=True, decode_kernel=False)), "cuda", 0)
    vx, ids = _graph_batch(gen, 3)
    g = Gen(max_new_tokens=12, eos_token_id=-1)
    graphed = OtterGenerator(model)
    eager = OtterGenerator(model, cuda_graph=False)
    assert graphed.cuda_graph and not eager.cuda_graph
    want, want_n = _launch_diff(lambda: eager.generate(vx, ids, gen=g))
    assert want_n["decode_attn_megakernel"] == 11 * 2
    for _ in range(2):      # capture, then replays only
        got, got_n = _launch_diff(lambda: graphed.generate(vx, ids, gen=g))
        assert (got == want).all() and got_n == want_n
    assert graphed._entries[-1].graph is not None
    st = graphed._prefill(vx, ids, None, g)
    try:
        graphed._advance(st)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(4):
                graphed._advance(st)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finally:
        graphed._finish(st)


def test_graphed_pool_equals_the_eager_pool(gen):
    """`ContinuousBatcher` captures its pooled step on the card by default:
    greedy requests (chunked prefills among them) and a beam request at
    once through a graphed pool of 4 and through `cuda_graph=False` give
    the same tokens, every pooled step launches the same kernels (a
    replay counts what its capture recorded), and the graphs hold the
    two keys (with and without the beam group's logits); a sampled
    request alone in a fresh pool of each kind gives the same tokens (one
    seed; the generator registered with the graphs draws as the eager
    steps do)."""
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation.batching import ContinuousBatcher
    model = _card_otter()
    reqs = _card_requests(gen, (9, 12, 15, 20, 14, 11))
    greedy = Gen(max_new_tokens=8, eos_token_id=-1)
    gens = [greedy] * 4 + [Gen(max_new_tokens=6, num_beams=2)]
    sampled = Gen(max_new_tokens=8, do_sample=True, temperature=1.5,
                  top_k=50, top_p=0.95, eos_token_id=-1)

    def pool(cuda_graph):
        return ContinuousBatcher(model, num_slots=4, cache_len=64,
                                 buckets=(16, 32), prefill_chunk=8,
                                 cache_dtype=torch.int8,
                                 max_admits_per_iter=4, cuda_graph=cuda_graph)

    def run(cuda_graph):
        b = pool(cuda_graph)
        steps, step = [], b._run_step

        def counted(need_logits):
            out, n = _launch_diff(lambda: step(need_logits))
            steps.append(n)
            return out
        b._run_step = counted
        try:
            streams = [b.submit(*r, g) for r, g in zip(reqs, gens)]
            got = [list(s) for s in streams]
            keys = sorted(b._graphs)
        finally:
            b.shutdown()
        assert b._failure is None and b.cuda_graph == (cuda_graph is None)
        b = pool(cuda_graph)
        try:
            got.append(list(b.submit(*reqs[5], sampled)))
        finally:
            b.shutdown()
        return got, steps, keys

    graphed, g_steps, keys = run(None)
    eager, e_steps, _ = run(False)
    assert graphed == eager
    assert [len(t) for t in graphed[:4]] == [8] * 4 and len(graphed[5]) == 8
    want = {"int8_mlp": 3, "decode_attention": 2}
    assert g_steps and e_steps and all(
        n == want for n in g_steps + e_steps), (g_steps, e_steps)
    assert keys == [((), False), ((), True)]


def test_failed_capture_raises_and_drops_its_entry(gen, monkeypatch):
    """A step that reads a device value on the host cannot be captured:
    the request raises (no quiet eager step), the entry is dropped, and
    the engine captures again once the step is fixed."""
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation import sampling
    from otter_tpu_torch.generation.engine import OtterGenerator
    model = _card_otter()
    vx, ids = _graph_batch(gen, 2)
    g = Gen(max_new_tokens=6, eos_token_id=-1)
    engine = OtterGenerator(model, cache_dtype=torch.int8)
    real = sampling.sample_token

    def syncing(logits, **kw):
        float(logits.max())
        return real(logits, **kw)
    monkeypatch.setattr(sampling, "sample_token", syncing)
    with pytest.raises(RuntimeError):
        engine.generate(vx, ids, gen=g)
    assert engine._entries == []
    monkeypatch.setattr(sampling, "sample_token", real)
    out = engine.generate(vx, ids, gen=g)
    assert engine._entries[-1].graph is not None
    eager = OtterGenerator(model, cache_dtype=torch.int8, cuda_graph=False)
    assert (eager.generate(vx, ids, gen=g) == out).all()


# ── the captured beam step and OtterHD's step ────────────────────────

def _per_step(run, new):
    """The launches a decode step of `run(n)` (a request of n new tokens):
    the difference between n = `new` and n = 1 over the `new` - 1 steps."""
    _, one = _launch_diff(lambda: run(1))
    out, full = _launch_diff(lambda: run(new))
    return out, {k: (n - one.get(k, 0)) / (new - 1) for k, n in full.items()
                 if n != one.get(k, 0)}


def _recorded(entry):
    """An entry's record of a replay's launches, by the counters' names."""
    from otter_tpu_torch.tools import bench_decode
    names = {id(w): n for n, w in (
        ("flash_fwd", fa.flash_attention), ("int8_mlp", quant.int8_mlp),
        ("decode_attention", da.decode_attention),
        ("int8_matmul", quant.int8_matmul))}
    assert set(bench_decode.kernel_launches()) >= set(names.values())
    return {names[id(w)]: n for (w, _), n in entry.launches.items()}


def _counting_captures(engine):
    captured, capture = [], engine._capture

    def counted(entry):
        capture(entry)
        captured.append(entry)
    engine._capture = counted
    return captured


def _no_sync_in_replays(engine, st):
    """Four replays of a captured step under
    `set_sync_debug_mode("error")`, then the request's entry back."""
    try:
        engine._advance(st)
        assert st.entry.graph is not None
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(4):
                engine._advance(st)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finally:
        engine._finish(st)


def test_graphed_beam_search_equals_eager_with_its_launches(gen):
    """Beams on the card (2 requests x 3 beams, no-repeat 2-grams): the
    graphed engine's `generate(num_beams=3)` and `stream_beam_generate`
    give the eager step's beams (`cuda_graph=False`) with its launches a
    step; the key's first request captures once and a second request
    only replays, a replay adding what its capture recorded; replays make
    no host sync."""
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation.engine import OtterGenerator
    model = _card_otter()
    vx, ids = _graph_batch(gen, 2)
    g = lambda n: Gen(max_new_tokens=n, num_beams=3, no_repeat_ngram_size=2)
    eager = OtterGenerator(model, cache_dtype=torch.int8, cuda_graph=False)
    graphed = OtterGenerator(model, cache_dtype=torch.int8)
    assert graphed.cuda_graph and not eager.cuda_graph
    want, want_step = _per_step(lambda n: eager.generate(vx, ids, gen=g(n)),
                                10)
    # (2 decoder layers and the xattn block's FF)
    assert want_step == {"int8_mlp": 3, "decode_attention": 2}
    captured = _counting_captures(graphed)
    for i in range(2):
        got, got_step = _per_step(
            lambda n: graphed.generate(vx, ids, gen=g(n)), 10)
        assert (got == want).all() and got_step == want_step
        assert len(captured) == 1      # n = 1 makes no step
    entry = captured[0]
    assert entry.key[4] == g(10)
    assert entry.capture_ms > 0 and entry.pool_bytes >= 0
    assert _recorded(entry) == want_step
    streamed = list(graphed.stream_beam_generate(vx[:1], ids[:1], gen=g(10),
                                                 chunk=4))
    cont = eager.generate(vx[:1], ids[:1], gen=g(10))[0, ids.shape[1]:]
    cont = cont.tolist()
    eoc = model.cfg.eoc_token_id
    assert streamed[-1] == (cont[:cont.index(eoc)] if eoc in cont else cont)
    _no_sync_in_replays(graphed, graphed._beam_prefill(vx, ids, None, g(10)))


def _card_fuyu():
    """A small FuyuVLM on the card with seeded random weights: int8
    decoder, int8 embedding table and head, head dim 64."""
    from otter_tpu_torch.config import FuyuConfig
    from otter_tpu_torch.tools.random_weights import build_model
    cfg = FuyuConfig.tiny()
    cfg = cfg.replace(text=cfg.text.replace(
        hidden_size=256, intermediate_size=1024, quant="int8",
        quant_embed=True, decode_kernel="auto"))
    return build_model(cfg, "cuda", 2)


def test_graphed_fuyu_step_equals_eager_with_its_launches(gen):
    """OtterHD's step on the card (a 12x8 image and 14 prompt tokens, an
    int8 cache): the graphed `FuyuGenerator` gives the eager step's
    tokens with its launches a step (`int8_mlp` and `decode_attention`
    once a layer, the head's `int8_matmul` once); the key's first request
    captures once, a second only replays (its record equal to a step's
    launches); replays make no host sync."""
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation.fuyu import FuyuGenerator
    from otter_tpu_torch.tools.random_weights import fuyu_request
    model = _card_fuyu()
    req = fuyu_request(model.cfg, 12, 8, 14, 5)
    g = lambda n: Gen(max_new_tokens=n, eos_token_id=-1)
    eager = FuyuGenerator(model, torch.int8, cuda_graph=False)
    graphed = FuyuGenerator(model, torch.int8)
    assert graphed.cuda_graph and not eager.cuda_graph
    want, want_step = _per_step(lambda n: list(eager.generate(*req, g(n))),
                                12)
    assert want_step == {"int8_mlp": 2, "decode_attention": 2,
                         "int8_matmul": 1}
    captured = _counting_captures(graphed)
    for _ in range(2):
        got, got_step = _per_step(
            lambda n: list(graphed.generate(*req, g(n))), 12)
        assert got == want and got_step == want_step
        assert len(captured) == 1      # one key: n = 1 makes no step
    assert _recorded(captured[0]) == want_step
    assert captured[0].capture_ms > 0
    _no_sync_in_replays(graphed, graphed._prefill(*req, g(12)))


# ── the captured speculative round, pooled round and session step ───

@pytest.mark.parametrize("sampled", [False, True])
def test_graphed_speculative_round_equals_eager_with_its_launches(
        gen, sampled):
    """`SpeculativeGenerator` on the card captures its round by default
    (gamma 3): `generate` and `stream` give the eager round's tokens
    (`cuda_graph=False`; a sampled request the same seed's), every round
    the same launches; a second request of the key, of another prompt
    length, only replays; replays make no host sync."""
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation.speculative import SpeculativeGenerator
    model, draft = _card_otter(), _card_draft()
    reqs = _card_requests(gen, (13, 21))
    g = Gen(max_new_tokens=12, eos_token_id=-1, do_sample=sampled,
            temperature=1.5, top_k=50)
    seeded = lambda: (torch.Generator(device="cuda").manual_seed(7)
                      if sampled else None)
    eager = SpeculativeGenerator(model, draft, gamma=3,
                                 cache_dtype=torch.int8, cuda_graph=False)
    graphed = SpeculativeGenerator(model, draft, gamma=3,
                                   cache_dtype=torch.int8)
    assert graphed.cuda_graph and not eager.cuda_graph
    captured = _counting_captures(graphed)
    for vx, ids in reqs:
        want, want_n = _launch_diff(lambda: eager.generate(
            vx, ids, gen=g, generator=seeded()))
        got, got_n = _launch_diff(lambda: graphed.generate(
            vx, ids, gen=g, generator=seeded()))
        assert (got == want).all() and got_n == want_n
        assert (graphed.last_emitted, graphed.last_rounds) == (
            eager.last_emitted, eager.last_rounds)
        assert len(captured) == 1
    assert _recorded(captured[0]) == {"int8_mlp": 2 + 2 * 2 + 3,
                                      "decode_attention": 2 * 1}
    vx, ids = reqs[0]
    assert list(graphed.stream(vx, ids, gen=g, generator=seeded())) == \
        list(eager.stream(vx, ids, gen=g, generator=seeded()))
    gen_, eos, cache_len = graphed._setup(ids, g)
    _no_sync_in_replays(graphed, graphed._prefill(vx, ids, None, gen_, eos,
                                                  seeded(), cache_len))


def test_graphed_spec_pool_equals_the_eager_pool(gen):
    """A pool of 4 with the draft (gamma 2) and the controller on, its
    cadence cut so that one run probes gamma 2, gamma 1 and plain decode:
    graphed by default on the card (each mode's body and the catch-up
    captured once under its key) and with `cuda_graph=False`, the greedy
    requests give the same tokens; a replayed round makes no host
    sync."""
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation.batching import ContinuousBatcher
    model, draft = _card_otter(), _card_draft()
    reqs = _card_requests(gen, (9, 12, 15))

    def run(cuda_graph):
        b = ContinuousBatcher(model, num_slots=4, cache_len=128,
                              buckets=(16,), cache_dtype=torch.int8,
                              max_admits_per_iter=4, draft=draft,
                              spec_gamma=2, spec_adaptive=True,
                              cuda_graph=cuda_graph)
        b._replan_every, b._probe_len = 4, 2
        try:
            got = [list(s) for s in [b.submit(vx, ids, Gen(
                max_new_tokens=30, eos_token_id=-1)) for vx, ids in reqs]]
            keys = sorted(map(str, b._graphs))
        finally:
            b._stop = True
            b._thread.join(10)
            b._finisher.join(10)
        assert b._failure is None and b.cuda_graph == (cuda_graph is None)
        return got, keys, b

    graphed, keys, b = run(None)
    eager = run(False)[0]
    assert graphed == eager and [len(t) for t in graphed] == [30] * 3
    assert str(("spec", 2, (), False)) in keys
    key = ("spec", 2, (), False)
    b._graphed(key, lambda: b._spec_body(2))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            b._graphed(key, lambda: b._spec_body(2))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    b.shutdown()


@pytest.mark.parametrize("kind", ["plain", "spec"])
def test_graphed_session_turns_equal_eager(gen, kind):
    """Three turns of one conversation through a `ChatSession` (or a
    `SpecChatSession` over the draft) on the card, graphed by default and
    with `cuda_graph=False`: the same tokens each turn; one capture, at the
    first turn, replayed by the turns after it."""
    import numpy as np
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation import session
    from otter_tpu_torch.generation.speculative import SpeculativeGenerator
    model, draft = _card_otter(), _card_draft()
    vx, ids = _card_requests(gen, (14,))[0]
    g = Gen(max_new_tokens=10, eos_token_id=-1)
    kw = dict(cache_len=256, prompt_bucket=16, window_bucket=8, min_reuse=4)

    def make(cuda_graph):
        if kind == "plain":
            return session.ChatSession(model, cache_dtype=torch.int8,
                                       cuda_graph=cuda_graph, **kw)
        return session.SpecChatSession(SpeculativeGenerator(
            model, draft, gamma=3, cache_dtype=torch.int8,
            cuda_graph=cuda_graph), **kw)

    graphed, eager = make(None), make(False)
    assert graphed.steps.cuda_graph and not eager.steps.cuda_graph
    captured = _counting_captures(graphed.steps)
    prompt = ids
    for turn in range(3):
        want = list(eager.stream(vx, prompt, gen=g))
        got = list(graphed.stream(vx, prompt, gen=g))
        assert got == want, turn
        assert graphed.last_stats == eager.last_stats
        assert len(captured) == 1
        prompt = np.concatenate([prompt, np.asarray([got]),
                                 np.asarray([[7, 8, 9]])], 1)
    assert not graphed.last_stats["restart"]


def test_cache_ladder_counts_a_captured_pool(gen):
    """After a capture on the card the ladder counts the graph's memory
    pool as taken: with the headroom set so that a bf16 cache fits only if
    the pool's bytes were free, the ladder steps down to int8, and once
    the graph is freed it keeps bf16."""
    from otter_tpu_torch.config import GenerationConfig as Gen
    from otter_tpu_torch.generation import engine
    model = _card_otter()
    vx, ids = _graph_batch(gen, 2)
    eng = engine.OtterGenerator(model, cache_dtype=torch.int8)
    eng.generate(vx, ids, gen=Gen(max_new_tokens=6, eos_token_id=-1))
    entry = eng._entries[-1]
    dev = model.device
    pool = engine.held_pool_bytes(dev)
    assert entry.graph is not None and pool >= entry.pool_bytes > 0
    text = model.cfg.text
    rows = -(-4 * pool // engine.cache_bytes(text, 1, 1024, torch.bfloat16))
    need = engine.cache_bytes(text, rows, 1024, torch.bfloat16)
    free = (torch.cuda.mem_get_info(dev)[1]
            - torch.cuda.memory_allocated(dev))
    pick = lambda: engine.select_cache_dtype(
        text, rows, 1024, torch.bfloat16, device=dev,
        headroom_bytes=free - need - pool // 2)
    with pytest.warns(UserWarning, match="degraded bf16 -> int8"):
        assert pick() == torch.int8
    eng.close()
    assert engine.held_pool_bytes(dev) == pool - entry.pool_bytes
    if engine.held_pool_bytes(dev) == 0:
        assert pick() == torch.bfloat16
