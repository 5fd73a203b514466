"""Ring attention: sequence-parallel self-attention over a mesh axis
(counterpart of `otter_tpu/ops/ring_attention.py`).

Each rank of the axis's group holds one chunk of the sequence: its
queries, and one KV block that rotates around the ring (rank j sends to
j + 1) while the queries' outputs merge block by block.

  - The forward (`_ring_fwd_pass` in JAX): the own (diagonal) block first,
    through the port's `flash_attention(..., causal=True,
    return_lse=True)`, then n - 1 steps that each rotate the KV block
    (with its column-bias block and its kv ids) before they compute it
    with `causal=False`. Under causality a block from a later chunk
    (src > idx) is skipped. Blocks merge by their LSE weights.
  - The backward is a two-pass `torch.autograd.Function`, as the JAX
    custom VJP is: the forward saves q, k, v, out and lse only; the
    backward rotates the KV blocks again, dq accumulates at home and each
    block's dk / dv (and dbias, where the bias takes a gradient) rides the
    ring with its block and comes home after one final rotation. A block
    pair runs the flash backward kernels (`flash_bwd_dkv`, `flash_bwd_dq`)
    with the global lse and delta = rowsum(do * out); CPU tensors take
    their plain versions, as every wrapper does.
  - `grad_mode="ad"` is plain autograd through a forward loop of plain
    block statistics; its rotation's backward rotates the other way.

GQA: the kv blocks rotate at their own head count; each block broadcasts
them to the query heads, and each query-head group's dk / dv is summed
back.

A query row that may attend no key of the whole sequence gets what the
port's `flash_attention` over the whole sequence gives it: the mean of v
over every key (in the backward, 1 / S of its gradient on every key's
dv). The per-block LSE merge cannot give that (such a row's LSE is
~0.69 * mask_value in every block, where log(count) is lost in f32), so
the ring sums v over every block it sees, skipped ones too, and puts the
mean in such rows at the end. The JAX ring sums the per-block means there
instead (ROADMAP Queue 3).

`ring_attention` takes full-sequence tensors, the same on every rank of
the group (the port's sequence-parallel layout: `ops/attention.py`), and
returns the full output on each; `ring_attention_local` runs the same
per-rank code for n ranks in one process, the rotation done by index.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from otter_tpu_torch.ops import flash_attention as fa
from otter_tpu_torch.ops.masks import DEFAULT_MASK_VALUE


class _RingConfig(NamedTuple):
    causal: bool
    scale: float
    ids_mode: str
    mask_value: float


# ── the rotation ────────────────────────────────────────────────────


class ProcessRing:
    """One member, this rank of `group`; rank j sends to j + 1."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        me = dist.get_rank(group)
        self.idx = [me]
        self._next = dist.get_global_rank(group, (me + 1) % self.n)
        self._prev = dist.get_global_rank(group, (me - 1) % self.n)

    def split(self, x, dim):
        return [x]

    def join(self, xs, dim):
        return xs[0]

    def rotate(self, members, back: bool = False):
        send, recv = ((self._prev, self._next) if back
                      else (self._next, self._prev))
        ops, outs = [], []
        for t in members[0]:
            if t is None:
                outs.append(None)
                continue
            t = t.contiguous()
            buf = torch.empty_like(t)
            ops += [dist.P2POp(dist.isend, t, send, self.group),
                    dist.P2POp(dist.irecv, buf, recv, self.group)]
            outs.append(buf)
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return [tuple(outs)]


class LocalRing:
    """n members in one process; rotation by index."""

    def __init__(self, n: int):
        self.n = n
        self.idx = list(range(n))

    def split(self, x, dim):
        if x is None:
            return [None] * self.n
        return list(x.chunk(self.n, dim=dim))

    def join(self, xs, dim):
        return torch.cat(xs, dim=dim)

    def rotate(self, members, back: bool = False):
        n = self.n
        return [members[(j + 1) % n] if back else members[(j - 1) % n]
                for j in range(n)]


class _Rotate(torch.autograd.Function):
    """A process ring's rotation whose backward rotates the other way."""

    @staticmethod
    def forward(ctx, ring, *xs):
        ctx.ring = ring
        return ring.rotate([xs])[0]

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + ctx.ring.rotate([gs], back=True)[0]


def _rotate_ad(ring, members):
    if isinstance(ring, LocalRing):
        return ring.rotate(members)
    xs = members[0]
    live = [x for x in xs if x is not None]
    out = iter(_Rotate.apply(ring, *live))
    return [tuple(None if x is None else next(out) for x in xs)]


# ── blocks ──────────────────────────────────────────────────────────


def _expand(x: torch.Tensor, h: int) -> torch.Tensor:
    return x if x.shape[1] == h else x.repeat_interleave(h // x.shape[1], 1)


def _fold(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, H, S, D] -> [B, H_kv, S, D], each query-head group summed."""
    b, h, s, d = x.shape
    return x if h == hkv else x.reshape(b, hkv, h // hkv, s, d).sum(2)


def _block_fwd(q, k, v, bias, qid, kid, cfg: _RingConfig, diag: bool):
    """-> (normalized out f32, lse [B, H, Sq] f32) of one block pair."""
    h = q.shape[1]
    o, lse = fa.flash_attention(
        q, _expand(k, h), _expand(v, h), bias, qid, kid,
        causal=diag and cfg.causal, sm_scale=cfg.scale,
        ids_mode=cfg.ids_mode, mask_value=cfg.mask_value, return_lse=True)
    return o.float(), lse


def _merge(o_a, lse_a, o_b, lse_b):
    lse = torch.logaddexp(lse_a, lse_b)
    return (o_a * torch.exp(lse_a - lse)[..., None]
            + o_b * torch.exp(lse_b - lse)[..., None]), lse


def _allowed(q_len, k_len, q_off, kv_off, qid, kid, cfg, device):
    """Bool [B|1, 1, Sq, Sk] of the pairs that may attend, or None."""
    mask = None
    if cfg.causal:
        rows = q_off + torch.arange(q_len, device=device)[:, None]
        cols = kv_off + torch.arange(k_len, device=device)[None, :]
        mask = (cols <= rows)[None, None]
    if qid is not None:
        qi = qid.int()[:, None, :, None]
        ki = kid.int()[:, None, None, :]
        idm = (qi == ki) if cfg.ids_mode == "eq" else (qi >= ki)
        mask = idm if mask is None else mask & idm
    return mask


def _block_dbias(q, k, v, bias, qid, kid, lse, delta, do, cfg, diag):
    """dbias of one block pair in plain PyTorch ([B|1, H|1, 1, Sk])."""
    h = q.shape[1]
    kf, vf = _expand(k, h).float(), _expand(v, h).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * cfg.scale \
        + bias.float()
    p = torch.exp(s - lse[..., None])
    mask = _allowed(q.shape[2], k.shape[2], 0, 0, qid, kid,
                    cfg._replace(causal=diag and cfg.causal), q.device)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vf)
    db = (p * (dp - delta[..., None])).sum(2, keepdim=True)
    if bias.shape[1] == 1:
        db = db.sum(1, keepdim=True)
    elif bias.shape[1] != h:
        db = db.reshape(db.shape[0], bias.shape[1], -1, 1,
                        db.shape[-1]).sum(2)
    if bias.shape[0] == 1:
        db = db.sum(0, keepdim=True)
    return db


def _block_bwd(q, k, v, bias, qid, kid, lse, delta, do, cfg, diag,
               need_db):
    """(dq, dk, dv, dbias) of one block pair, f32; dk / dv at the block's
    own kv heads."""
    h, hkv = q.shape[1], k.shape[1]
    kf, vf = _expand(k, h), _expand(v, h)
    kw = dict(causal=diag and cfg.causal, sm_scale=cfg.scale,
              ids_mode=cfg.ids_mode, mask_value=cfg.mask_value)
    dk, dv = fa.flash_bwd_dkv(q, kf, vf, bias, qid, kid, lse, delta, do,
                              **kw)
    dq = fa.flash_bwd_dq(q, kf, vf, bias, qid, kid, lse, delta, do, **kw)
    db = (_block_dbias(q, k, v, bias, qid, kid, lse, delta, do, cfg, diag)
          if need_db else None)
    return dq.float(), _fold(dk.float(), hkv), _fold(dv.float(), hkv), db


def _masked_rows(lse, cfg):
    return lse < 0.5 * cfg.mask_value


def _may_mask(bias, qid) -> bool:
    """Whether some row may attend no key: only ids or a bias can mask
    every key of a row (a causal row always attends its diagonal)."""
    return bias is not None or qid is not None


# ── the two passes, over the ring's members ─────────────────────────


def _ring_fwd_pass(ring, qs, ks, vs, biases, qids, kids, cfg):
    """-> [(out, lse)] a member; out in q's dtype, lse f32 [B, H, Sq]."""
    n = ring.n
    seq = qs[0].shape[2] * n
    fix = _may_mask(biases[0], qids[0])
    state = [list(_block_fwd(qs[j], ks[j], vs[j], biases[j], qids[j],
                             kids[j], cfg, True))
             for j in range(len(qs))]
    vsum = [vs[j].float().sum(2) if fix else None for j in range(len(qs))]
    blocks = [(ks[j], vs[j], biases[j], kids[j]) for j in range(len(qs))]
    for i in range(1, n):
        blocks = ring.rotate(blocks)
        for j, idx in enumerate(ring.idx):
            kb, vb, bb, kib = blocks[j]
            if fix:
                vsum[j] = vsum[j] + vb.float().sum(2)
            if cfg.causal and (idx - i) % n > idx:
                continue
            o_b, lse_b = _block_fwd(qs[j], kb, vb, bb, qids[j], kib, cfg,
                                    False)
            state[j] = list(_merge(*state[j], o_b, lse_b))
    out = []
    for j in range(len(qs)):
        o, lse = state[j]
        if fix:
            h = qs[j].shape[1]
            mean = _expand(vsum[j][:, :, None] / seq, h)   # [B, H, 1, D]
            o = torch.where(_masked_rows(lse, cfg)[..., None], mean, o)
        out.append((o.to(qs[j].dtype), lse))
    return out


def _ring_bwd_pass(ring, qs, ks, vs, biases, qids, kids, outs, lses, dos,
                   cfg, need_db):
    """-> [(dq, dk, dv, dbias)] a member, in the inputs' dtypes."""
    n = ring.n
    m = len(qs)
    seq = qs[0].shape[2] * n
    fix = _may_mask(biases[0], qids[0])
    deltas, dos_eff, dmeans = [], [], []
    for j in range(m):
        delta = (outs[j].float() * dos[j].float()).sum(-1)
        dmean = None
        do = dos[j]
        if fix:
            # a row that attends no key: no dq, no dk, and 1/S of its
            # gradient on every key's dv (added as the blocks pass by)
            masked = _masked_rows(lses[j], cfg)
            do = torch.where(masked[..., None], torch.zeros_like(do), do)
            delta = torch.where(masked, torch.zeros_like(delta), delta)
            dmean = _fold((dos[j].float() * masked[..., None]).sum(
                2, keepdim=True) / seq, ks[j].shape[1])
        deltas.append(delta)
        dos_eff.append(do)
        dmeans.append(dmean)
    dqs = [None] * m
    accs = []
    for j, idx in enumerate(ring.idx):
        dq, dk, dv, db = _block_bwd(qs[j], ks[j], vs[j], biases[j], qids[j],
                                    kids[j], lses[j], deltas[j], dos_eff[j],
                                    cfg, True, need_db)
        if fix:
            dv = dv + dmeans[j]
        dqs[j] = dq
        accs.append((dk, dv, db))
    blocks = [(ks[j], vs[j], biases[j], kids[j]) for j in range(m)]
    for i in range(1, n):
        # the block and its gradient accumulator travel together
        blocks = ring.rotate(blocks)
        accs = ring.rotate(accs)
        for j, idx in enumerate(ring.idx):
            kb, vb, bb, kib = blocks[j]
            dk_a, dv_a, db_a = accs[j]
            if fix:
                dv_a = dv_a + dmeans[j]
            if not (cfg.causal and (idx - i) % n > idx):
                dq_b, dk_b, dv_b, db_b = _block_bwd(
                    qs[j], kb, vb, bb, qids[j], kib, lses[j], deltas[j],
                    dos_eff[j], cfg, False, need_db)
                dqs[j] = dqs[j] + dq_b
                dk_a, dv_a = dk_a + dk_b, dv_a + dv_b
                if need_db:
                    db_a = db_a + db_b
            accs[j] = (dk_a, dv_a, db_a)
    if n > 1:
        # each block is n - 1 hops from home: one more rotation
        accs = ring.rotate(accs)
    res = []
    for j in range(m):
        dk, dv, db = accs[j]
        res.append((dqs[j].to(qs[j].dtype), dk.to(ks[j].dtype),
                    dv.to(vs[j].dtype),
                    None if db is None else db.to(biases[j].dtype)))
    return res


def _split_all(ring, q, k, v, bias, q_ids, kv_ids):
    return (ring.split(q, 2), ring.split(k, 2), ring.split(v, 2),
            ring.split(bias, 3), ring.split(q_ids, 1),
            ring.split(kv_ids, 1))


class _RingFn(torch.autograd.Function):
    """The two-pass ring: q, k, v (bias, ids) are a process ring's local
    chunks, or a local ring's whole sequence."""

    @staticmethod
    def forward(ctx, q, k, v, bias, q_ids, kv_ids, ring, cfg):
        parts = _split_all(ring, q, k, v, bias, q_ids, kv_ids)
        res = _ring_fwd_pass(ring, *parts, cfg)
        out = ring.join([o for o, _ in res], 2)
        lse = ring.join([l for _, l in res], 2)
        ctx.save_for_backward(q, k, v, bias, q_ids, kv_ids, out, lse)
        ctx.ring, ctx.cfg = ring, cfg
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, q_ids, kv_ids, out, lse = ctx.saved_tensors
        ring = ctx.ring
        need_db = bias is not None and ctx.needs_input_grad[3]
        parts = _split_all(ring, q, k, v, bias, q_ids, kv_ids)
        res = _ring_bwd_pass(ring, *parts, ring.split(out, 2),
                             ring.split(lse, 2), ring.split(do, 2), ctx.cfg,
                             need_db)
        dq = ring.join([r[0] for r in res], 2)
        dk = ring.join([r[1] for r in res], 2)
        dv = ring.join([r[2] for r in res], 2)
        db = None
        if need_db:
            dbs = [r[3] for r in res]
            db = ring.join(dbs, 3)
        return dq, dk, dv, db, None, None, None, None


def _stats(q, k, v, bias, qid, kid, q_off, kv_off, cfg):
    """(out unnormalized, m, l) of one block pair, plain and
    differentiable, with global offsets."""
    h = q.shape[1]
    kf, vf = _expand(k, h).float(), _expand(v, h).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * cfg.scale
    if bias is not None:
        s = s + bias.float()
    mask = _allowed(q.shape[2], k.shape[2], q_off, kv_off, qid, kid, cfg,
                    q.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, cfg.mask_value))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf), m, p.sum(-1, keepdim=True)


def _ring_ad(ring, q, k, v, bias, q_ids, kv_ids, cfg):
    """Autograd through the forward loop (the A/B path): every block is
    computed (no causal skip), each under checkpoint so its probabilities
    are recomputed in the backward."""
    qs, ks, vs, bs, qis, kis = _split_all(ring, q, k, v, bias, q_ids,
                                          kv_ids)
    n = ring.n
    chunk = qs[0].shape[2]
    acc = []
    for j, idx in enumerate(ring.idx):
        acc.append(list(checkpoint(_stats, qs[j], ks[j], vs[j], bs[j],
                                   qis[j], kis[j], idx * chunk, idx * chunk,
                                   cfg, use_reentrant=False)))
    blocks = [(ks[j], vs[j], bs[j], kis[j]) for j in range(len(qs))]
    for i in range(1, n):
        blocks = _rotate_ad(ring, blocks)
        for j, idx in enumerate(ring.idx):
            kb, vb, bb, kib = blocks[j]
            src = (idx - i) % n
            o_b, m_b, l_b = checkpoint(_stats, qs[j], kb, vb, bb, qis[j], kib,
                                       idx * chunk, src * chunk, cfg,
                                       use_reentrant=False)
            o, m, l = acc[j]
            m_new = torch.maximum(m, m_b)
            a, b = torch.exp(m - m_new), torch.exp(m_b - m_new)
            acc[j] = [o * a + o_b * b, m_new, l * a + l_b * b]
    outs = []
    for j in range(len(qs)):
        o, _, l = acc[j]
        l = torch.where(l == 0, torch.ones_like(l), l)
        outs.append((o / l).to(qs[j].dtype))
    return ring.join(outs, 2)


def _config(q, causal, sm_scale, ids_mode, mask_value, bias, q_ids, kv_ids):
    if (q_ids is None) != (kv_ids is None):
        raise ValueError("q_ids and kv_ids must be passed together")
    if bias is not None and not (bias.dim() == 4 and bias.shape[2] == 1):
        raise ValueError(f"ring attention takes a column bias "
                         f"[B|1, H|1, 1, S], not {tuple(bias.shape)}")
    scale = float(sm_scale if sm_scale is not None
                  else 1.0 / (q.shape[-1] ** 0.5))
    return _RingConfig(bool(causal), scale, ids_mode, float(mask_value))


def _run(ring, q, k, v, bias, q_ids, kv_ids, cfg, grad_mode):
    if grad_mode == "ad":
        return _ring_ad(ring, q, k, v, bias, q_ids, kv_ids, cfg)
    if grad_mode != "ring":
        raise ValueError(f"unknown grad_mode {grad_mode!r} "
                         "(expected 'ring' or 'ad')")
    return _RingFn.apply(q, k, v, bias, q_ids, kv_ids, ring, cfg)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis: str = "seq", causal: bool = True,
                   sm_scale: Optional[float] = None,
                   bias: Optional[torch.Tensor] = None,
                   q_ids: Optional[torch.Tensor] = None,
                   kv_ids: Optional[torch.Tensor] = None,
                   ids_mode: str = "eq", grad_mode: str = "ring",
                   mask_value: float = DEFAULT_MASK_VALUE) -> torch.Tensor:
    """q [B, H, S, D], k / v [B, H_kv, S, D], the same on every rank of the
    mesh axis's group; returns [B, H, S, D] on each. Each rank attends its
    S / n queries over the ring, and the chunks are gathered. `bias` is
    column form [B|1, H|1, 1, S] (ALiBi); ids are [B, S].

    grad_mode: "ring" (the two-pass backward) or "ad" (autograd through
    the forward loop)."""
    from otter_tpu_torch.parallel import collectives as col
    from otter_tpu_torch.parallel.mesh import axis_group, axis_size
    n = axis_size(mesh, axis)
    if q.shape[2] % n:
        raise ValueError(f"ring attention: sequence length {q.shape[2]} is "
                         f"not divisible by the '{axis}' axis ({n})")
    cfg = _config(q, causal, sm_scale, ids_mode, mask_value, bias, q_ids,
                  kv_ids)
    group = axis_group(mesh, axis)
    if group is None:
        return _run(LocalRing(1), q, k, v, bias, q_ids, kv_ids, cfg,
                    grad_mode)
    ql, kl, vl = (col.split(t, 2, group) for t in (q, k, v))
    bl = None if bias is None else col.split(bias, 3, group)
    qi = None if q_ids is None else col.local_slice(q_ids, 1, group)
    ki = None if kv_ids is None else col.local_slice(kv_ids, 1, group)
    out = _run(ProcessRing(group), ql, kl, vl, bl, qi, ki, cfg, grad_mode)
    return col.gather(out, 2, group)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, n: int, causal: bool = True,
                         sm_scale: Optional[float] = None,
                         bias: Optional[torch.Tensor] = None,
                         q_ids: Optional[torch.Tensor] = None,
                         kv_ids: Optional[torch.Tensor] = None,
                         ids_mode: str = "eq", grad_mode: str = "ring",
                         mask_value: float = DEFAULT_MASK_VALUE
                         ) -> torch.Tensor:
    """`ring_attention` of n ranks run in this process: the same per-rank
    block, merge and rotation code, the rotation done by index."""
    if q.shape[2] % n:
        raise ValueError(f"ring attention: sequence length {q.shape[2]} is "
                         f"not divisible by {n}")
    cfg = _config(q, causal, sm_scale, ids_mode, mask_value, bias, q_ids,
                  kv_ids)
    return _run(LocalRing(n), q, k, v, bias, q_ids, kv_ids, cfg, grad_mode)


def ring_attention_local_bwd(q, k, v, out, lse, do, *, n: int,
                             causal: bool = True, sm_scale=None, bias=None,
                             q_ids=None, kv_ids=None, ids_mode: str = "eq",
                             mask_value: float = DEFAULT_MASK_VALUE):
    """(dq, dk, dv) of the n-rank ring's backward pass alone, given its
    forward's out and lse (`ring_attention_local_fwd`)."""
    ring = LocalRing(n)
    cfg = _config(q, causal, sm_scale, ids_mode, mask_value, bias, q_ids,
                  kv_ids)
    parts = _split_all(ring, q, k, v, bias, q_ids, kv_ids)
    res = _ring_bwd_pass(ring, *parts, ring.split(out, 2), ring.split(lse, 2),
                         ring.split(do, 2), cfg, False)
    return tuple(ring.join([r[i] for r in res], 2) for i in range(3))


def ring_attention_local_fwd(q, k, v, *, n: int, causal: bool = True,
                             sm_scale=None, bias=None, q_ids=None,
                             kv_ids=None, ids_mode: str = "eq",
                             mask_value: float = DEFAULT_MASK_VALUE):
    """(out, lse [B, H, S] f32) of the n-rank ring's forward pass alone."""
    ring = LocalRing(n)
    cfg = _config(q, causal, sm_scale, ids_mode, mask_value, bias, q_ids,
                  kv_ids)
    res = _ring_fwd_pass(ring, *_split_all(ring, q, k, v, bias, q_ids,
                                           kv_ids), cfg)
    return (ring.join([o for o, _ in res], 2),
            ring.join([l for _, l in res], 2))
