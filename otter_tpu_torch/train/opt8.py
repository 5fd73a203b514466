"""Blockwise 8-bit Adam states (counterpart of `otter_tpu/train/opt8.py`,
the bitsandbytes 8-bit-optimizer idea, Dettmers et al. 2022).

Adam's m / v are per-parameter accumulators: storing them as int8 blocks
(dequantize -> f32 update -> requantize) cuts the optimizer's memory from
8 to ~2.02 bytes a parameter. With bf16 trainable parameters no f32 master
is kept either, which is what lets the 7B SFT recipe (an int8 frozen
decoder, bf16 trainables) fit one card with room to spare.

Quantization, the JAX module's layout and arithmetic:
  - mu (signed): absmax int8 per `BLOCK` values, `[nblocks, BLOCK]` int8
    and `[nblocks, 1]` f32 scales.
  - nu (non-negative, ~6 orders of dynamic range): absmax int8 in sqrt
    space; nu enters the update only as sqrt(nu).

`Adam8` is the JAX chain `clip_by_global_norm -> scale_by_adam8 ->
add_decayed_weights -> scale_by_learning_rate` (`otter_tpu/train/step.py:
121-128`), applied to the parameters in place. A tensor is updated in
chunks of 16 MB of f32 blocks, so no full-size f32 copy of it lives at
once; within a chunk the step, the decay and the learning rate are f32 and
the parameter is rounded to its dtype once (the JAX chain rounds the step
to a bf16 parameter's dtype before the decay and again after the rate).

Over sharded parameters (`parallel.sharding`), the blocks follow the
global flat layout, so FSDP's shards (and their padding) and the
tensor-parallel slices move no block boundary: a rank keeps int8 moments
for its local elements ([n_local]) and the f32 scales of every global
block ([nblocks, 1]); each block's absmax is the max over the ranks that
hold part of it (one all-reduce a chunk, which every rank of the tensor's
groups makes, holding part of the chunk or not). The one update serves
both layouts, and the moments equal the single-device step's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from otter_tpu_torch.parallel import collectives as col
from otter_tpu_torch.parallel.sharding import (global_flat_index,
                                               local_count_below)
from otter_tpu_torch.train.step import AdamW, OptState, Params

BLOCK = 512
CHUNK_BYTES = 16 << 20
CHUNK_BLOCKS = CHUNK_BYTES // (4 * BLOCK)


def block_scales(amax: torch.Tensor, groups=()) -> torch.Tensor:
    """A block's absmax (first the max over the ranks of each of
    `groups`) -> its f32 scale: amax / 127, 1 for an all-zero block."""
    for g in groups:
        amax = col.all_reduce_max(amax, g)
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def quantize_blocks(x: torch.Tensor, groups=()):
    """f32 [..., nb, block] -> (int8 [..., nb, block], f32 scale
    [..., nb, 1]): absmax per row (`block_scales`)."""
    scale = block_scales(x.abs().amax(dim=-1, keepdim=True), groups)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _zero_states(p: torch.Tensor):
    nb = -(-p.numel() // BLOCK)
    return (torch.zeros((nb, BLOCK), dtype=torch.int8, device=p.device),
            torch.ones((nb, 1), dtype=torch.float32, device=p.device))


class Adam8(AdamW):
    """clip_by_global_norm -> 8-bit Adam -> decoupled weight decay (on the
    parameter, masked) -> learning rate, optionally inside MultiSteps
    (the accumulator is AdamW's, f32)."""

    def __init__(self, schedule: Callable[[int], float],
                 decay: Dict[str, bool], *, weight_decay: float,
                 grad_clip: float, grad_accum_steps: int = 1,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8):
        super().__init__(schedule, decay, weight_decay=weight_decay,
                         grad_clip=grad_clip,
                         grad_accum_steps=grad_accum_steps, b1=b1, b2=b2,
                         eps=eps)
        self.chunk_blocks = CHUNK_BLOCKS

    def _sharded(self, k):
        lay = self.layouts.get(k)
        return lay if lay is not None and lay.index else None

    def init(self, params: Params) -> OptState:
        mu, mu_s, nu, nu_s = {}, {}, {}, {}
        for k, p in params.items():
            lay = self._sharded(k)
            if lay is not None:
                nb = -(-math.prod(lay.shape) // BLOCK)
                for q, sc in ((mu, mu_s), (nu, nu_s)):
                    q[k] = torch.zeros(p.numel(), dtype=torch.int8,
                                       device=p.device)
                    sc[k] = torch.ones((nb, 1), dtype=torch.float32,
                                       device=p.device)
                continue
            mu[k], mu_s[k] = _zero_states(p)
            nu[k], nu_s[k] = _zero_states(p)
        acc = ({k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()} if self.accum > 1 else {})
        return OptState(master={}, mu=mu, nu=nu, mu_s=mu_s, nu_s=nu_s,
                        acc=acc)

    def _apply(self, grads, state: OptState, params: Params) -> None:
        g_norm = self.norm_fn(grads)
        clip = g_norm < self.grad_clip
        lr = self.schedule(state.count)
        state.count += 1
        # the bias corrections in f32, as the JAX module computes them
        c1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(
            state.count))
        c2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(
            state.count))
        for k, p in params.items():
            wd = self.weight_decay if self.decay.get(k, False) else 0.0
            self._update_tensor(self._sharded(k), grads[k], p, state.mu[k],
                                state.mu_s[k], state.nu[k], state.nu_s[k],
                                clip, g_norm, c1, c2, lr, wd)

    def _update_tensor(self, lay, g, p, mq, ms, nq, ns, clip, g_norm, c1,
                       c2, lr, wd) -> None:
        """One tensor, a chunk of whole global blocks at a time, laid out
        as the chunk's [blocks, BLOCK] grid: a whole tensor (`lay` None)
        fills it in order, a shard puts its elements at their global
        places and leaves the rest 0, which moves no absmax; a block's
        absmax is then the max over the ranks that hold part of it."""
        block = BLOCK
        shape = lay.shape if lay is not None else tuple(p.shape)
        n = math.prod(shape)
        g_flat, p_flat = g.reshape(-1), p.reshape(-1)   # (a copy if strided)
        for b0 in range(0, ms.shape[0], self.chunk_blocks):
            b1 = min(b0 + self.chunk_blocks, ms.shape[0])
            size = (b1 - b0) * block
            if lay is None:
                e0, e1 = b0 * block, min(b1 * block, n)
                pos = None
            else:
                e0, e1 = (local_count_below(lay, p.shape, b * block)
                          for b in (b0, b1))
                if e0 == e1:      # none of these blocks here: their scales
                    scale = block_scales(ms.new_zeros((2, b1 - b0, 1)),
                                         lay.groups)
                    ms[b0:b1], ns[b0:b1] = scale[0], scale[1]
                    continue
                pos = global_flat_index(lay, p.shape, e0, e1,
                                        p.device) - b0 * block

            def grid(x):
                """Local elements [e0, e1) -> the chunk's f32 grid."""
                x = x.float()
                if pos is None:
                    return F.pad(x, (0, size - x.numel())).view(-1, block)
                return x.new_zeros(size).index_put_((pos,), x).view(
                    -1, block)

            # optax's clip: g / norm * limit where the norm is over it
            gc = grid(g_flat[e0:e1])
            gc = torch.where(clip, gc, gc / g_norm * self.grad_clip)
            if lay is None:
                mu, nu_sqrt = mq[b0:b1].float(), nq[b0:b1].float()
            else:
                mu, nu_sqrt = grid(mq[e0:e1]), grid(nq[e0:e1])
            mu = self.b1 * (mu * ms[b0:b1]) + (1.0 - self.b1) * gc
            nu_sqrt = nu_sqrt * ns[b0:b1]
            nu = self.b2 * (nu_sqrt * nu_sqrt) + (1.0 - self.b2) * gc * gc
            step = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            q, scale = quantize_blocks(torch.stack([mu, torch.sqrt(nu)]),
                                       lay.groups if lay is not None else ())
            ms[b0:b1], ns[b0:b1] = scale[0], scale[1]
            if lay is None:
                mq[b0:b1], nq[b0:b1] = q[0], q[1]
                step = step.view(-1)[:e1 - e0]
            else:
                mq[e0:e1], nq[e0:e1] = q[0].view(-1)[pos], q[1].view(-1)[pos]
                step = step.view(-1)[pos]
            pc = p_flat[e0:e1].float()
            if wd:
                step = step + wd * pc
            p_flat[e0:e1] = (pc - lr * step).to(p.dtype)
        if p_flat.data_ptr() != p.data_ptr():
            p.copy_(p_flat.view(p.shape))
