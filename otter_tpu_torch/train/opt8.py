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
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from otter_tpu_torch.train.step import AdamW, OptState, Params, global_norm

BLOCK = 512
CHUNK_BYTES = 16 << 20
CHUNK_BLOCKS = CHUNK_BYTES // (4 * BLOCK)


def quantize_blocks(x: torch.Tensor):
    """f32 [nb, block] -> (int8 [nb, block], f32 scale [nb, 1]): absmax
    per row, scale 1 for an all-zero row."""
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
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

    def init(self, params: Params) -> OptState:
        mu, mu_s, nu, nu_s = {}, {}, {}, {}
        for k, p in params.items():
            mu[k], mu_s[k] = _zero_states(p)
            nu[k], nu_s[k] = _zero_states(p)
        acc = ({k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()} if self.accum > 1 else {})
        return OptState(master={}, mu=mu, nu=nu, mu_s=mu_s, nu_s=nu_s,
                        acc=acc)

    def _apply(self, grads, state: OptState, params: Params) -> None:
        g_norm = global_norm(grads.values())
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
            self._update_tensor(grads[k], p, state.mu[k], state.mu_s[k],
                                state.nu[k], state.nu_s[k], clip, g_norm,
                                c1, c2, lr, wd)

    def _update_tensor(self, g, p, mq, ms, nq, ns, clip, g_norm, c1, c2,
                       lr, wd) -> None:
        block, n = BLOCK, p.numel()
        g_flat, p_flat = g.reshape(-1), p.view(-1)
        for b0 in range(0, mq.shape[0], self.chunk_blocks):
            b1 = min(b0 + self.chunk_blocks, mq.shape[0])
            e0, e1 = b0 * block, min(b1 * block, n)
            gc = g_flat[e0:e1].float()
            # optax's clip: g / norm * limit where the norm is over it
            gc = torch.where(clip, gc, gc / g_norm * self.grad_clip)
            if (b1 - b0) * block > e1 - e0:       # the last block's tail
                gc = F.pad(gc, (0, (b1 - b0) * block - (e1 - e0)))
            gc = gc.view(b1 - b0, block)
            mu = mq[b0:b1].float() * ms[b0:b1]
            nu_sqrt = nq[b0:b1].float() * ns[b0:b1]
            mu = self.b1 * mu + (1.0 - self.b1) * gc
            nu = self.b2 * (nu_sqrt * nu_sqrt) + (1.0 - self.b2) * gc * gc
            step = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            mq[b0:b1], ms[b0:b1] = quantize_blocks(mu)
            nq[b0:b1], ns[b0:b1] = quantize_blocks(torch.sqrt(nu))
            step = step.view(-1)[:e1 - e0]
            pc = p_flat[e0:e1].float()
            if wd:
                step = step + wd * pc
            p_flat[e0:e1] = (pc - lr * step).to(p.dtype)
