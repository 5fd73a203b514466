"""Single-query cached attention (counterpart of
`otter_tpu/ops/decode_attention.py`).

`decode_attention` launches the hand-written CUDA kernel
`csrc/decode_attention.cu` for CUDA tensors and runs
`decode_attention_plain` for CPU tensors. It reads the stacked cache
[B, n_layers, H, L, D] with the layer chosen by index (no per-layer copy
of the cache), attends only positions in [starts[b], lengths[b]), adds an
optional ALiBi column bias [B|1, H|1, L], and takes bf16, int8 or int4
caches (quantized caches with f32 per-position scales: the k scale
multiplies the logits after q.k, the v scale the probabilities before
p.v). An int4 cache (`kv_bits=4`) is one fused array, k in the low nibble
of each byte and v in the high (`ops.quant.quantize_kv_int4`), passed as
both `k` and `v` and read through one pointer.

The kernel splits each (batch, head)'s span over several CTAs so that the
grid fills the card: `split_plan` picks the number of splits from the
shapes alone (the host never reads `starts` / `lengths`), the kernel cuts
the real span as `split_chunks` does, and the chunks' partial (m, l, acc)
are merged in chunk order (`merge_partials` is the rule) in a workspace
(`Workspace`): one shared per device, or one that a captured CUDA graph
owns (`owned_workspace`).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional

import torch

from otter_tpu_torch import _build
from otter_tpu_torch.ops.masks import DEFAULT_MASK_VALUE

_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
_SIGNATURES = {"decode_attention_bf16": (
    [_P, _P, _P, _P, _P, _I, _P, _LL, _LL, _P, _P, _P, _P, _P, _I, _I, _I,
     _I, _I, _I, _I, _I, _F, _P], _I)}

# head dims the kernel takes (the cache's D)
KERNEL_HEAD_DIMS = (64, 128)

# The split plan. One CTA of the kernel holds 54 KB of shared memory, so
# four share an SM of the H100's 132: the plan aims at one wave of them.
SM_COUNT = 132
CTAS_PER_SM = 4
# the fewest k and v bytes a chunk reads: less and a CTA's fixed costs (its
# q, the merge) outweigh its reads
MIN_CHUNK_BYTES = 32768
# bytes of k and v a cache position holds, by cache kind (0 bf16, 1 int8,
# 2 fused int4), per head-dim element
_KV_BYTES = {0: 4, 1: 2, 2: 1}


def split_plan(b: int, h: int, span: int, d: int, kind: int):
    """(splits, min_rows) of a call: B * H * splits CTAs at most one wave
    of the card, and chunks of at least `min_rows` positions
    (MIN_CHUNK_BYTES of k and v) but a row's last. `span` is the longest
    span a row may have (the cache length, on the host); the kernel cuts
    each row's real span with `split_chunks`. A pure function of the shapes
    and the cache kind."""
    min_rows = max(1, MIN_CHUNK_BYTES // (_KV_BYTES[kind] * d))
    by_grid = SM_COUNT * CTAS_PER_SM // max(1, b * h)
    return max(1, min(by_grid, span // min_rows)), min_rows


def split_chunks(start: int, length: int, splits: int, min_rows: int):
    """The chunks [lo, hi) the kernel's CTAs take of one row's span
    [start, length), in chunk order (the kernel clamps start to >= 0 and
    length to <= L first): none if the span is empty, else at most
    `splits` of equal length (the last shorter), none empty, and all but
    the last at least `min_rows` long (or the whole span)."""
    span = length - start
    if span <= 0:
        return []
    n = max(1, min(splits, span // min_rows))
    chunk = -(-span // n)
    return [(lo, min(lo + chunk, length))
            for lo in range(start, length, chunk)]


def merge_partials(parts):
    """The kernel's merge of chunk partials, in chunk order. `parts` holds
    one (m, l, acc) a chunk: m [...] the chunk's largest logit, l [...] its
    sum of exp(s - m), acc [..., D] its sum of p v (f32). A chunk with
    m = -inf (no valid key) adds nothing. -> acc / l [..., D] (l == 0 ->
    1)."""
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    l_all = torch.zeros_like(m_all)
    acc_all = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.where(m == float("-inf"), torch.zeros_like(m),
                        torch.exp(m - m_all))
        l_all = l_all + l * f
        acc_all = acc_all + acc * f[..., None]
    l_inv = torch.where(l_all == 0, torch.ones_like(l_all), 1.0 / l_all)
    return acc_all * l_inv[..., None]


def workspace_size(b: int, h: int, splits: int, d: int):
    """(f32 elements, int32 counters) of the workspace a call of `splits`
    splits needs: (m, l, acc[D]) for every chunk of every (batch, head),
    and one counter a (batch, head)."""
    return b * h * splits * (2 + d), b * h


class Workspace:
    """(partials f32, counters int32) of the split kernels, per device:
    `decode_attention`'s and the megakernel's attention kernel's. Each user
    reads and writes them within one launch, and launches on one stream
    run in turn (the megakernel's attention kernel is a programmatic
    dependent launch that touches them only after `pdl_wait`, when the
    launch before it has finished), so calls on one stream share them. The
    counters must start at 0, and the kernel leaves them so.

    `get` grows a pair to the largest call made with it: the larger pair
    replaces the smaller, which stays alive while a caller holds it. Once
    `frozen` (a graph has recorded the pair's addresses), a call that
    needs more raises instead. Threads may share one: `get` is locked."""

    def __init__(self):
        self.frozen = False
        self._pairs = {}
        self._lock = threading.Lock()

    def get(self, device: torch.device, floats: int, rows: int):
        with self._lock:
            ws, cnt = self._pairs.get(device.index, (None, None))
            grow_ws = ws is None or ws.numel() < floats
            grow_cnt = cnt is None or cnt.numel() < rows
            if self.frozen and (grow_ws or grow_cnt):
                raise RuntimeError(
                    f"decode_attention: a call needs a workspace of "
                    f"{floats} floats and {rows} counters, more than the "
                    f"frozen one a CUDA graph recorded holds")
            if grow_ws:
                ws = torch.empty(max(floats, 1), dtype=torch.float32,
                                 device=device)
            if grow_cnt:
                cnt = torch.zeros(max(rows, 1), dtype=torch.int32,
                                  device=device)
            self._pairs[device.index] = (ws, cnt)
        return ws, cnt

    def tensors(self):
        """The pairs it holds, {device index: (partials, counters)}."""
        with self._lock:
            return dict(self._pairs)


# every call that no graph owns; a graph's own is `owned_workspace`'s
_shared = Workspace()
_owner = threading.local()


@contextlib.contextmanager
def owned_workspace(ws: Workspace):
    """Calls on this thread inside the block use `ws` in place of the
    shared workspace. A CUDA graph's owner runs one eager step with it
    before the capture (so the pair exists at its size), freezes it and
    keeps it for the graph's lifetime: a later, larger call elsewhere grows
    the shared pair and never frees, resizes or writes the graph's."""
    prev = getattr(_owner, "ws", None)
    _owner.ws = ws
    try:
        yield ws
    finally:
        _owner.ws = prev


def _workspace(device: torch.device, floats: int, rows: int):
    """(partials f32, counters int32) of at least `floats` and `rows`
    elements on `device`: this thread's owned workspace, or the shared
    one."""
    ws = getattr(_owner, "ws", None) or _shared
    return ws.get(device, floats, rows)


def decode_attention_plain(q, k, v, lengths, bias=None, starts=None, *,
                           k_scale=None, v_scale=None, kv_bits: int = 8,
                           layer: Optional[int] = None, sm_scale=None,
                           mask_value=DEFAULT_MASK_VALUE):
    """The kernel's function in plain PyTorch, one block covering the
    whole cache."""
    if layer is not None:
        k, v = k[:, layer], v[:, layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[:, layer], v_scale[:, layer]
    if kv_bits == 4 and k_scale is not None:
        k, v = ((k & 0xF) ^ 8) - 8, v >> 4   # sign-extended nibbles
    L, d = k.shape[2], q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    quant = k_scale is not None
    if starts is None:
        starts = torch.zeros_like(lengths)
    kk = k.to(q.dtype) if quant else k
    s = torch.einsum("bhd,bhld->bhl", q.float(), kk.float())
    if quant:
        s = s * k_scale.float()
    s = s * sm_scale
    if bias is not None:
        s = s + bias.float()
    pos = torch.arange(L, device=q.device)[None, None, :]
    ok = (pos < lengths.long()[:, None, None]) \
        & (pos >= starts.long()[:, None, None])
    s = torch.where(ok, s, torch.full_like(s, mask_value))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    if quant:
        p = p * v_scale.float()
    vv = v.to(q.dtype) if quant else v
    o = torch.einsum("bhl,bhld->bhd", p.to(vv.dtype).float(), vv.float())
    l_inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    return (o * l_inv[..., None]).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     starts: Optional[torch.Tensor] = None, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     kv_bits: int = 8, layer: Optional[int] = None,
                     sm_scale: Optional[float] = None,
                     mask_value: float = DEFAULT_MASK_VALUE) -> torch.Tensor:
    """q [B, H, D]; k/v [B, H, L, D], or the stacked [B, n_layers, H, L, D]
    cache with `layer` given (scales [B(, n_layers), H, L]); lengths and
    starts [B] int. -> [B, H, D]. With scales and `kv_bits=4`, k and v are
    the same fused int4 array. CUDA tensors: q bf16, cache bf16 or int8,
    D in {64, 128}."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k, v, lengths, bias, starts, k_scale=k_scale,
            v_scale=v_scale, kv_bits=kv_bits, layer=layer,
            sm_scale=sm_scale, mask_value=mask_value)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, h, d = q.shape
    if layer is None:   # one layer: a stacked cache of depth 1
        k, v, layer = k[:, None], v[:, None], 0
        if k_scale is not None:
            k_scale, v_scale = k_scale[:, None], v_scale[:, None]
    nl, L = k.shape[1], k.shape[3]
    if k.shape != (b, nl, h, L, d) or v.shape != k.shape \
            or not 0 <= layer < nl:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(k.shape)}, layer {layer}")
    quant = k_scale is not None
    int4 = quant and kv_bits == 4
    want = torch.int8 if quant else torch.bfloat16
    if q.dtype != torch.bfloat16 or k.dtype != want or v.dtype != want:
        raise TypeError("decode_attention kernel takes bf16 q with a bf16 "
                        "cache, or an int8 or fused int4 cache with scales")
    if int4 and (v.data_ptr() != k.data_ptr() or v.stride() != k.stride()):
        raise ValueError("decode_attention kernel: an int4 cache is one "
                         "fused array, passed as both k and v")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"decode_attention kernel: head dim {d}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention kernel: the cache must be "
                         "contiguous (it is read in place, never copied)")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention kernel: misaligned cache")
    if quant and not (k_scale.is_contiguous() and v_scale.is_contiguous()
                      and k_scale.dtype == torch.float32
                      and v_scale.dtype == torch.float32
                      and k_scale.shape == k.shape[:4]
                      and v_scale.shape == k.shape[:4]):
        raise ValueError("decode_attention kernel: scales must be "
                         "contiguous f32 [B, n_layers, H, L]")
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    q = q.contiguous()
    if q.data_ptr() % 16:   # the kernel reads q in 16-byte loads
        q = q.clone()
    lengths = lengths.to(torch.int32).contiguous()
    starts = (torch.zeros_like(lengths) if starts is None
              else starts.to(torch.int32).contiguous())
    bias_ptr, bstrides = None, (0, 0)
    if bias is not None:
        bias = bias.float()
        if bias.dim() != 3 or bias.shape[0] not in (1, b) \
                or bias.shape[1] not in (1, h) or bias.shape[2] != L:
            raise ValueError(f"decode_attention: bias {tuple(bias.shape)}")
        if bias.stride(2) != 1:
            bias = bias.contiguous()
        bstrides = tuple(0 if n == 1 else st for n, st in
                         zip(bias.shape[:2], bias.stride()[:2]))
        bias_ptr = bias.data_ptr()
    out = torch.empty_like(q)
    kind = 2 if int4 else int(quant)
    splits, min_rows = split_plan(b, h, L, d, kind)
    ws = cnt = None
    if splits > 1:
        ws, cnt = _workspace(q.device, *workspace_size(b, h, splits, d))
    lib = _build.library("decode_attention", _SIGNATURES)
    err = lib.decode_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, kind, bias_ptr,
        *bstrides, lengths.data_ptr(), starts.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if cnt is None else cnt.data_ptr(),
        b, h, nl, layer, L, d, splits, min_rows, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "decode_attention")
    _build.count_launch(decode_attention, int4=int4)
    return out


decode_attention.launches = 0        # every launch
decode_attention.launches_int4 = 0   # those over an int4 cache
