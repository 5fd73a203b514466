"""Attention dispatcher (counterpart of `otter_tpu/ops/attention.py`).

The models call this one entry point. `impl="kernel"` takes the flash
kernels (`ops/flash_attention.py`, differentiable through their backward
kernels), `impl="ref"` the plain reference (`ops/attention_ref.py`,
differentiable through torch autograd). The default, `default_impl`, is
the kernel for CUDA tensors and the reference elsewhere, as the JAX
package takes Pallas on a TPU and the reference elsewhere. Sub-tile shapes
(q <= 8 and kv <= 256: decode-time cross-attention) go to the reference
even on CUDA: a launch costs more than the math there. Training never
meets them (its shortest query axis is the perceiver's 64 latents).

Under `sequence_parallel(mesh)` eligible self-attention runs as the ring
(`ops/ring_attention.py`) over the mesh's "seq" axis: causal, S_q == S_kv
> 1, and any bias in column form [.., 1, S] (the decoder's ALiBi). A
sequence that the axis does not divide raises, as in JAX; other calls
take the normal path.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from otter_tpu_torch.ops import attention_ref
from otter_tpu_torch.ops import flash_attention as fa
from otter_tpu_torch.ops.masks import DEFAULT_MASK_VALUE


class _SeqParallelState(threading.local):
    def __init__(self):
        self.stack = []


# thread-local: a serving thread's prefill must not see a trainer
# thread's ring routing, nor the other way round
_SEQ_PARALLEL = _SeqParallelState()


@contextlib.contextmanager
def sequence_parallel(mesh, axis: str = "seq"):
    """Route eligible self-attention through the ring over `axis` while
    the context is open; nothing at extent 1."""
    from otter_tpu_torch.parallel.mesh import axis_size
    if axis_size(mesh, axis) <= 1:
        yield
        return
    _SEQ_PARALLEL.stack.append((mesh, axis))
    try:
        yield
    finally:
        _SEQ_PARALLEL.stack.pop()


def _maybe_ring(q, k, v, bias, q_ids, kv_ids, ids_mode, causal, sm_scale):
    """The ring's output when the sequence_parallel context applies, else
    None."""
    if not _SEQ_PARALLEL.stack or not causal:
        return None
    from otter_tpu_torch.parallel.mesh import axis_size
    mesh, axis = _SEQ_PARALLEL.stack[-1]
    n = axis_size(mesh, axis)
    s_q, s_k = q.shape[2], k.shape[2]
    if s_q != s_k or s_q <= 1:
        return None
    if s_q % n != 0:
        raise ValueError(
            f"sequence_parallel: sequence length {s_q} is not divisible "
            f"by the '{axis}' mesh axis ({n}); pad the sequence to a "
            f"multiple of sp or lower --sp")
    if bias is not None and not (bias.dim() == 4 and bias.shape[2] == 1):
        return None
    from otter_tpu_torch.ops.ring_attention import ring_attention
    return ring_attention(q, k, v, mesh=mesh, axis=axis, causal=True,
                          sm_scale=sm_scale, bias=bias, q_ids=q_ids,
                          kv_ids=kv_ids, ids_mode=ids_mode)


def default_impl(q: torch.Tensor) -> str:
    return "kernel" if q.is_cuda else "ref"


def multi_head_attention(
    q: torch.Tensor,                         # [B, H, S_q, D]
    k: torch.Tensor,                         # [B, H_kv, S_k, D]
    v: torch.Tensor,                         # [B, H_kv, S_k, D]
    *,
    bias: Optional[torch.Tensor] = None,     # [B|1, H|1, S_q|1, S_k]
    q_ids: Optional[torch.Tensor] = None,    # int32 [B, S_q]
    kv_ids: Optional[torch.Tensor] = None,   # int32 [B, S_k]
    ids_mode: str = "eq",
    causal: bool = False,
    sm_scale: Optional[float] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    # the ring first, before the GQA broadcast: it rotates the model's own
    # kv heads
    ring = _maybe_ring(q, k, v, bias, q_ids, kv_ids, ids_mode, causal,
                       sm_scale)
    if ring is not None:
        return ring
    impl = impl or default_impl(q)
    h, h_kv = q.shape[1], k.shape[1]
    if h_kv != h:
        k = k.repeat_interleave(h // h_kv, dim=1)
        v = v.repeat_interleave(h // h_kv, dim=1)
    if impl == "kernel" and q.shape[2] <= 8 and k.shape[2] <= 256:
        impl = "ref"
    if impl == "kernel":
        return fa.flash_attention(
            q, k, v, bias, q_ids, kv_ids, causal=causal, sm_scale=sm_scale,
            ids_mode=ids_mode)
    if impl == "ref":
        mask = None
        if q_ids is not None:
            qi = q_ids[:, None, :, None].int()
            ki = kv_ids[:, None, None, :].int()
            mask = (qi == ki) if ids_mode == "eq" else (qi >= ki)
        return attention_ref.mha_reference(
            q, k, v, bias=bias, mask=mask, causal=causal, sm_scale=sm_scale,
            mask_value=DEFAULT_MASK_VALUE)
    raise ValueError(f"unknown attention impl {impl!r}")
