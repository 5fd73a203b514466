"""Parameter partition rules (counterpart of `otter_tpu/parallel/sharding.py`):
path regex -> spec over the ("data", "fsdp", "seq", "tensor") mesh, first
match wins, over the port's flax paths (`train.step.flax_path`).

`shard_params(mesh, model)` applies the specs to a model in place:

  - the tensor axis: Megatron-style slices. A decoder self-attention
    whose projections all carry it keeps only its rank's heads (q, k and
    v column-parallel, the out-projection row-parallel, one sum after
    it), so the flash kernels and the KV cache see the local heads; a
    decoder MLP keeps its rank's hidden columns the same way. Any other
    float projection the rules name is column-parallel with its output
    gathered, or row-parallel with its input split and its output summed.
  - the fsdp axis: `torch.distributed.fsdp.fully_shard` over data x fsdp
    (HSDP where dp > 1), each tensor sharded along the dim its spec gives
    the fsdp axis. Parameters whose spec has none stay whole
    (`ignored_params`), as `P()` replicates them in JAX.

Kernels always see plain tensors: `fully_shard` gathers a layer's
parameters into ordinary tensors for its forward and backward, and the
tensor-parallel slices are ordinary tensors. The int8 frozen weights are
buffers with no "/kernel" path: their spec is `P()` and `fully_shard`
never shards buffers, so they stay whole on every rank, as in JAX.

`model._shard_layouts` records, for every parameter, which global indices
its local tensor holds and which of them this rank counts
(`ShardLayout`): the optimizer's global norm, the 8-bit Adam's block
layout and the checkpoint's full tensors (gathered to rank 0 alone) are
computed from it.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from otter_tpu_torch.parallel import collectives as col
from otter_tpu_torch.parallel.mesh import (DATA_AXIS, FSDP_AXIS, MESH_AXES,
                                           SEQ_AXIS, TENSOR_AXIS, axis_group,
                                           axis_size)


class P(tuple):
    """A partition spec: one entry a dim, each None, an axis name or a
    tuple of axis names (JAX's `PartitionSpec` is such a tuple)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# (path regex, spec). First match wins. Paths are "/"-joined flax paths.
DEFAULT_RULES: List[Tuple[str, P]] = [
    # column-parallel (out-features over tensor, in over fsdp)
    (r".*(Wqkv|q_proj|k_proj|v_proj|up_proj|gate_proj|to_q|to_kv|ff_up|fc1)"
     r"/kernel$", P(FSDP_AXIS, TENSOR_AXIS)),
    # row-parallel (in-features over tensor, out over fsdp)
    (r".*(out_proj|down_proj|to_out|ff_down|fc2)/kernel$",
     P(TENSOR_AXIS, FSDP_AXIS)),
    (r".*lm_head/kernel$", P(FSDP_AXIS, TENSOR_AXIS)),
    # embedding: the feature dim only (a sharded vocab dim would not
    # partition the token gather)
    (r".*wte/embedding$", P(None, (FSDP_AXIS, TENSOR_AXIS))),
    (r".*/wpe$", P(None, FSDP_AXIS)),
    (r".*patch_embedding/kernel$", P(None, None, None, FSDP_AXIS)),
    (r".*position_embedding$", P(None, FSDP_AXIS)),
    (r".*(latents|frame_embs|media_time_embs)$", P()),
    # norms, biases, gates: replicated
    (r".*", P()),
]


def _spec_for(path: str, shape, rules) -> P:
    for pat, spec in rules:
        if re.fullmatch(pat, path):
            if len(spec) > len(shape):
                return P()
            return spec
    return P()


def _paths_and_shapes(tree) -> Dict[str, tuple]:
    if isinstance(tree, nn.Module):
        return {k.replace(".", "/"): tuple(v.shape)
                for k, v in tree.state_dict().items()}
    return {k: tuple(v.shape) for k, v in tree.items()}


def param_specs(tree, rules=None) -> Dict[str, P]:
    """{flax path: spec} for a module (its parameters and buffers) or a
    {flax path: array} mapping."""
    rules = rules or DEFAULT_RULES
    return {k: _spec_for(k, shape, rules)
            for k, shape in _paths_and_shapes(tree).items()}


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _safe_spec(spec: P, shape, sizes: Dict[str, int]) -> P:
    """Clear the axes whose extent does not divide the dim."""
    out = []
    for i, s in enumerate(spec):
        if s is None:
            out.append(None)
            continue
        n = math.prod(sizes.get(a, 1) for a in _names(s))
        out.append(s if i < len(shape) and shape[i] % n == 0 else None)
    return P(*out)


def mesh_sizes(mesh) -> Dict[str, int]:
    return {a: axis_size(mesh, a) for a in MESH_AXES}


# ── the layout of each parameter's local tensor ─────────────────────


@dataclass
class ShardLayout:
    """Where a local tensor sits in its global one: `index[d]` holds the
    global index of each local position along a sharded dim d; `own` (a
    bool tensor broadcastable to the local shape) marks the elements this
    rank counts once among the ranks that hold copies."""
    shape: Tuple[int, ...]
    index: Dict[int, torch.Tensor] = field(default_factory=dict)
    own: Optional[torch.Tensor] = None
    groups: Tuple = ()
    # on the ranks of rank 0's shard group (`gather_full`): the group and
    # each of its ranks' (local shape, index)
    gather_group: Optional[object] = None
    peers: Optional[list] = None

    def own_mask(self, local: torch.Tensor) -> torch.Tensor:
        if self.own is None:
            return torch.ones((), dtype=torch.bool, device=local.device)
        return self.own.to(local.device)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The local shard of a DTensor, or the tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def _own_dims(shape, dims_own: Dict[int, torch.Tensor], whole: bool):
    """A bool tensor broadcastable to `shape`: the product of per-dim
    masks, all False where `whole` is False."""
    if not whole:
        return torch.zeros((1,) * len(shape), dtype=torch.bool)
    own = torch.ones((1,) * len(shape), dtype=torch.bool)
    for d, m in dims_own.items():
        view = [1] * len(shape)
        view[d] = -1
        own = own & m.view(view)
    return own


def _scatter_index(index: Dict[int, torch.Tensor], shape) -> tuple:
    """Broadcast indices that put a local tensor of `shape` into its
    global one (`full[_scatter_index(...)] = local`)."""
    n = len(shape)
    return tuple((index[d] if d in index else torch.arange(shape[d]))
                 .view([-1 if i == d else 1 for i in range(n)])
                 for d in range(n))


def gather_full(layout: Optional[ShardLayout], local: torch.Tensor
                ) -> Optional[torch.Tensor]:
    """The global tensor of a local one, in its dtype. A whole copy is the
    rank's own (no collective). A shard is gathered to rank 0 alone over
    rank 0's shard group (its fsdp x tensor ranks: `layout.peers`), which
    assembles it on the host; every rank of that group calls this, and
    every rank but 0 gets None."""
    if layout is None or not layout.index:
        return local
    if layout.gather_group is None:       # outside rank 0's shard group
        return None
    n = max(math.prod(s) for s, _ in layout.peers)
    flat = torch.zeros(n, dtype=local.dtype, device=local.device)
    flat[:local.numel()] = local.reshape(-1)
    root = dist.get_rank() == 0
    bufs = [torch.empty_like(flat) for _ in layout.peers] if root else None
    dist.gather(flat, bufs, dst=0, group=layout.gather_group)
    if not root:
        return None
    full = torch.zeros(layout.shape, dtype=local.dtype)
    for buf, (shape, index) in zip(bufs, layout.peers):
        full[_scatter_index(index, shape)] = \
            buf[:math.prod(shape)].view(shape).cpu()
    return full


def local_of(layout: Optional[ShardLayout], full: torch.Tensor
             ) -> torch.Tensor:
    """This rank's local tensor of a global one."""
    if layout is None:
        return full
    for d, idx in sorted(layout.index.items()):
        full = full.index_select(d, idx.to(full.device))
    return full


def global_flat_index(layout: Optional[ShardLayout], local_shape,
                      start: int = 0, stop: Optional[int] = None,
                      device=None) -> torch.Tensor:
    """int64: the global row-major index of the local elements
    [start, stop) in the local row-major order (increasing: every index
    of a layout is)."""
    shape = layout.shape if layout is not None else tuple(local_shape)
    flat = torch.arange(start, math.prod(local_shape) if stop is None
                        else stop, device=device)
    out = torch.zeros_like(flat)
    stride = 1
    for d in reversed(range(len(local_shape))):
        flat, coord = flat.div(local_shape[d], rounding_mode="floor"), \
            flat.remainder(local_shape[d])
        if layout is not None and d in layout.index:
            coord = layout.index[d].to(coord.device)[coord]
        out += coord * stride
        stride *= shape[d]
    return out


def local_count_below(layout: ShardLayout, local_shape, bound: int) -> int:
    """How many local elements have a global row-major index below
    `bound`: where the local row-major order reaches it."""
    shape = layout.shape
    if bound >= math.prod(shape):
        return math.prod(local_shape)
    count, rest = 0, bound
    inner = math.prod(local_shape)
    for d in range(len(shape)):
        inner //= local_shape[d]
        c, rest = divmod(rest, math.prod(shape[d + 1:]))
        idx = layout.index.get(d)
        below = c if idx is None else int(torch.searchsorted(
            idx, torch.tensor(c, dtype=idx.dtype)))
        count += below * inner
        if idx is not None and not (below < len(idx) and int(idx[below]) == c):
            break                       # coordinate c is not held here
    return count


def sharded_sq_sum(layouts: Dict[str, ShardLayout],
                   tensors: Dict[str, torch.Tensor],
                   groups: Tuple) -> torch.Tensor:
    """Sum of squares of every global element, each counted once, f32."""
    total = None
    for k, t in tensors.items():
        t = local_tensor(t)
        lay = layouts.get(k)
        sq = t.float().square()
        if lay is not None and lay.own is not None:
            sq = torch.where(lay.own_mask(t), sq, torch.zeros_like(sq))
        s = sq.sum()
        total = s if total is None else total + s
    if total is None:
        total = torch.zeros(())
    for g in groups:
        total = col.all_reduce_sum(total, g)
    return total


# ── tensor parallelism ──────────────────────────────────────────────


_TP_CLASSES: Dict[Tuple[type, str], type] = {}


def _tp_class(base: type, kind: str) -> type:
    """A subclass of `base` (a float `Dense`) whose forward is column- or
    row-parallel; the module keeps its parameter names."""
    key = (base, kind)
    if key in _TP_CLASSES:
        return _TP_CLASSES[key]

    def column_forward(self, x):
        g = self.tp_group
        y = base.forward(self, col.copy_to(x, g))
        return col.gather(y, y.dim() - 1, g) if self.tp_gather else y

    def row_forward(self, x):
        g = self.tp_group
        if not self.tp_input_parallel:
            x = col.split(x, x.dim() - 1, g)
        y = col.reduce_from(x.to(self.dtype) @ self.kernel, g)
        return y + self.bias if self.bias is not None else y

    cls = type(f"{'Column' if kind == 'column' else 'Row'}Parallel"
               f"{base.__name__}", (base,),
               {"forward": column_forward if kind == "column"
                else row_forward})
    _TP_CLASSES[key] = cls
    return cls


def _keep(p: nn.Parameter, dim: int, idx: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(p.detach().index_select(dim, idx.to(p.device))
                        .clone(), requires_grad=p.requires_grad)


def _column(m, idx, own, group, gather: bool, prefix: str, layouts):
    full_out = m.kernel.shape[1]
    m.kernel = _keep(m.kernel, 1, idx)
    layouts[f"{prefix}/kernel"] = ((m.kernel.shape[0], full_out), 1, idx,
                                   own)
    if m.bias is not None:
        m.bias = _keep(m.bias, 0, idx)
        layouts[f"{prefix}/bias"] = ((full_out,), 0, idx, own)
    m.__class__ = _tp_class(type(m), "column")
    m.tp_group, m.tp_gather = group, gather


def _row(m, idx, group, input_parallel: bool, prefix: str, layouts):
    full_in = m.kernel.shape[0]
    m.kernel = _keep(m.kernel, 0, idx)
    layouts[f"{prefix}/kernel"] = ((full_in, m.kernel.shape[1]), 0, idx,
                                   None)
    m.__class__ = _tp_class(type(m), "row")
    m.tp_group, m.tp_input_parallel = group, input_parallel


def _has_tensor(spec: P, dim: int) -> bool:
    return dim < len(spec) and TENSOR_AXIS in _names(spec[dim])


def _contiguous(n: int, tp: int, t: int) -> torch.Tensor:
    per = n // tp
    return torch.arange(t * per, (t + 1) * per)


def _attention_heads(attn, prefix, specs, tp, t):
    """The head-local split of a decoder self-attention: ({projection
    name: (column indices, own mask)}, (h_loc, hk_loc)), or None where
    its heads cannot split (a projection outside the rules, heads that do
    not divide, or MPT's full-width qk LayerNorm)."""
    from otter_tpu_torch.ops.layers import Dense
    c = attn.cfg
    h, hk, d = c.num_attention_heads, c.kv_heads, c.head_dim
    names = (("q_proj", "k_proj", "v_proj") if c.arch == "llama"
             else ("Wqkv",)) + ("out_proj",)
    if any(type(getattr(attn, n)) is not Dense for n in names):
        return None
    if h % tp or (hk % tp and hk != 1) or (
            c.qk_ln and c.arch in ("mpt", "mosaic_gpt")):
        return None
    for n in names:
        if not _has_tensor(specs[f"{prefix}/{n}/kernel"],
                           0 if n == "out_proj" else 1):
            return None
    hl = h // tp
    kv_split = hk % tp == 0
    hkl = hk // tp if kv_split else hk
    q = torch.arange(t * hl * d, (t + 1) * hl * d)
    kv = (torch.arange(t * hkl * d, (t + 1) * hkl * d) if kv_split
          else torch.arange(hk * d))
    q_own = torch.ones(len(q), dtype=torch.bool)
    kv_own = torch.full((len(kv),), kv_split or t == 0, dtype=torch.bool)
    if c.arch == "llama":
        cols = {"q_proj": (q, q_own), "k_proj": (kv, kv_own),
                "v_proj": (kv, kv_own)}
    else:
        nq = h * d
        cols = {"Wqkv": (torch.cat([q, nq + kv, nq + hk * d + kv]),
                         torch.cat([q_own, kv_own, kv_own]))}
    cols["out_proj"] = (q, None)
    return cols, (hl, hkl)


def _apply_tensor_parallel(model: nn.Module, specs, group, tp: int,
                           t: int) -> Dict[str, tuple]:
    from otter_tpu_torch.models.decoder import MLP, SelfAttention
    from otter_tpu_torch.ops.layers import Dense
    raw: Dict[str, tuple] = {}
    done = set()
    for name, m in list(model.named_modules()):
        prefix = name.replace(".", "/")
        if isinstance(m, SelfAttention):
            split = _attention_heads(m, prefix, specs, tp, t)
            if split is None:
                continue
            cols, heads = split
            for n, (idx, own) in cols.items():
                sub = getattr(m, n)
                if n == "out_proj":
                    _row(sub, idx, group, True, f"{prefix}/{n}", raw)
                else:
                    _column(sub, idx, own, group, False, f"{prefix}/{n}",
                            raw)
                done.add(f"{prefix}/{n}")
            m.heads, m.head_offset = heads, t * heads[0]
            model.tp_kv_heads = heads[1]
        elif isinstance(m, MLP):
            names = [n for n in ("gate_proj", "up_proj", "down_proj")
                     if hasattr(m, n)]
            if any(type(getattr(m, n)) is not Dense for n in names) or any(
                    not _has_tensor(specs[f"{prefix}/{n}/kernel"],
                                    0 if n == "down_proj" else 1)
                    for n in names):
                continue
            idx = _contiguous(m.cfg.mlp_dim, tp, t)
            for n in names:
                sub = getattr(m, n)
                if n == "down_proj":
                    _row(sub, idx, group, True, f"{prefix}/{n}", raw)
                else:
                    _column(sub, idx, None, group, False, f"{prefix}/{n}",
                            raw)
                done.add(f"{prefix}/{n}")
    for name, m in list(model.named_modules()):
        prefix = name.replace(".", "/")
        if type(m) is not Dense or prefix in done:
            continue
        spec = specs.get(f"{prefix}/kernel", P())
        if _has_tensor(spec, 1):
            _column(m, _contiguous(m.kernel.shape[1], tp, t), None, group,
                    True, prefix, raw)
        elif _has_tensor(spec, 0):
            _row(m, _contiguous(m.kernel.shape[0], tp, t), group, False,
                 prefix, raw)
    return raw


# ── fully_shard ─────────────────────────────────────────────────────

_UNIT = re.compile(r"(layers|xattn|blocks?)_\d+")


def _fsdp_dim(spec: P) -> Optional[int]:
    for i, s in enumerate(spec):
        if FSDP_AXIS in _names(s):
            return i
    return None


def _apply_fsdp(model: nn.Module, specs, mesh) -> None:
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    dims: Dict[int, int] = {}
    ignored = set()
    for name, p in model.named_parameters():
        d = _fsdp_dim(specs.get(name.replace(".", "/"), P()))
        if d is None:
            ignored.add(p)
        else:
            dims[id(p)] = d
    fsdp_mesh = (mesh[DATA_AXIS, FSDP_AXIS] if axis_size(mesh, DATA_AXIS) > 1
                 else mesh[FSDP_AXIS])
    kw = dict(mesh=fsdp_mesh, ignored_params=ignored,
              shard_placement_fn=lambda p: Shard(dims.get(id(p), 0)))
    units = [m for n, m in model.named_modules()
             if _UNIT.fullmatch(n.rsplit(".", 1)[-1])
             and any(p not in ignored for p in m.parameters())]
    # innermost first: a unit inside another is sharded before its parent
    for m in reversed(units):
        fully_shard(m, **kw)
    fully_shard(model, **kw)
    if hasattr(model, "encode_vision"):
        # the generator calls it outside forward: it gathers as forward does
        from torch.distributed.fsdp import register_fsdp_forward_method
        register_fsdp_forward_method(model, "encode_vision")


def _layouts(model: nn.Module, mesh, tp_raw: Dict[str, tuple]
             ) -> Dict[str, ShardLayout]:
    fsdp_g, tp_g = axis_group(mesh, FSDP_AXIS), axis_group(mesh, TENSOR_AXIS)
    f_rank = dist.get_rank(fsdp_g) if fsdp_g is not None else 0
    f_size = axis_size(mesh, FSDP_AXIS)
    t_rank = dist.get_rank(tp_g) if tp_g is not None else 0
    groups = tuple(g for g in (fsdp_g, tp_g) if g is not None)
    out = {}
    for name, p in model.named_parameters():
        path = name.replace(".", "/")
        local = local_tensor(p)
        index: Dict[int, torch.Tensor] = {}
        dims_own: Dict[int, torch.Tensor] = {}
        shape = list(local.shape)
        if path in tp_raw:
            full_shape, d, idx, own = tp_raw[path]
            shape = list(full_shape)
            index[d] = idx
            if own is not None:
                dims_own[d] = own
        tp_whole = path in tp_raw or t_rank == 0
        fsdp_whole = True
        if hasattr(p, "placements"):
            d = next((pl.dim for pl in p.placements if hasattr(pl, "dim")),
                     None)
            if d is not None and f_size > 1:
                n = p.shape[d]
                per = -(-n // f_size)
                start = min(f_rank * per, n)
                stop = min(start + per, n)
                base = index.get(d)
                pos = torch.arange(start, stop)
                index[d] = pos if base is None else base[pos]
                if base is None:
                    shape[d] = n
                if d in dims_own:
                    dims_own[d] = dims_own[d][pos]
        else:
            fsdp_whole = f_rank == 0
        own = _own_dims(local.shape, dims_own, tp_whole and fsdp_whole)
        out[path] = ShardLayout(tuple(shape), index,
                                None if bool(own.all()) and own.numel() == 1
                                else own, groups)
    return out


def _share_layouts(model: nn.Module, mesh) -> None:
    """Tell the ranks of rank 0's shard group (data and seq coordinate 0)
    where each of them holds each sharded parameter, once, so that a save
    gathers only the tensors' data (`gather_full`)."""
    if axis_size(mesh, FSDP_AXIS) * axis_size(mesh, TENSOR_AXIS) == 1:
        return
    group = mesh[FSDP_AXIS, TENSOR_AXIS]._flatten().get_group()
    coord = mesh.get_coordinate()
    if coord[MESH_AXES.index(DATA_AXIS)] or coord[MESH_AXES.index(
            SEQ_AXIS)]:
        return
    lays = model._shard_layouts
    params = dict(model.named_parameters())
    mine = {k: (tuple(local_tensor(params[k.replace("/", ".")]).shape),
                lay.index) for k, lay in lays.items() if lay.index}
    peers = [None] * dist.get_world_size(group)
    dist.all_gather_object(peers, mine, group=group)
    for k in mine:
        lays[k].gather_group = group
        lays[k].peers = [p[k] for p in peers]


def shard_params(mesh, model: nn.Module, rules=None) -> nn.Module:
    """Apply the specs to `model` in place (see the module docstring) and
    return it. Call before the optimizer takes the parameters."""
    if mesh is None:
        return model
    sizes = mesh_sizes(mesh)
    shapes = _paths_and_shapes(model)
    specs = {k: _safe_spec(s, shapes[k], sizes)
             for k, s in param_specs(model, rules).items()}
    tp = sizes[TENSOR_AXIS]
    raw = {}
    if tp > 1:
        g = axis_group(mesh, TENSOR_AXIS)
        raw = _apply_tensor_parallel(model, specs, g, tp, dist.get_rank(g))
    _apply_fsdp(model, specs, mesh)
    model._shard_layouts = _layouts(model, mesh, raw)
    _share_layouts(model, mesh)
    model._shard_groups = tuple(
        g for g in (axis_group(mesh, FSDP_AXIS), axis_group(mesh, TENSOR_AXIS))
        if g is not None)
    return model
