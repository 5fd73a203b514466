"""Generation engine: batched left-padded prefill + KV-cached decode
(counterpart of `otter_tpu/generation/engine.py`).

`OtterGenerator.generate` encodes the vision input once, runs one prefill
that writes the stacked KV cache and computes only the last position's
logits (`head_last_only`), then decodes with single-token steps that
update the cache in place. The JAX engine runs the loop inside one jitted
`lax.while_loop` and `stream_generate` replays one compiled step; here
the step keeps its state on the device (the cache position and the step
index are device counters) and, on CUDA, is captured once per request
shape as a CUDA graph and replayed (`OtterGenerator`'s docstring).
`stream_generate` runs the same prefill and steps for one request and
yields each token as it is sampled; a `vision_mask` marks the real frames
of mixed still+video media.

`num_beams > 1` runs beam search (`generation/beam.py`) over B*K rows:
the prompt, its mask and the vision latents repeated K times a row (the
reference's repeat for beams, `modeling_otter.py:1030-1032`; the JAX
engine repeats the pixels, here the vision input is encoded once and its
latents repeated, the same values for one CLIP pass in K). Its step, the
counterpart of the JAX engine's jitted beam loop, keeps the search's
state on the device beside the cache and is captured as the greedy step
is. `stream_beam_generate` yields the current best beam every few steps.

The model is an `OtterVLM` or an `IdeficsVLM`: the engine asks of it
`encode_vision(vision_x, vision_mask)` (latents [B, N, m, D]), the forward
signature of both, `device`, and a config with `.text`,
`.media_token_id` and `.eoc_token_id`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time
import warnings
import weakref
from types import SimpleNamespace
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from otter_tpu_torch import _build
from otter_tpu_torch.config import (GenerationConfig, IdeficsModelConfig,
                                    OtterConfig, TextConfig)
from otter_tpu_torch.generation import beam, sampling
from otter_tpu_torch.models.decoder import init_cache
from otter_tpu_torch.models.idefics import IdeficsVLM
from otter_tpu_torch.models.otter import OtterVLM
from otter_tpu_torch.ops import decode_attention as da

CacheDtype = Union[torch.dtype, str]
Model = Union[OtterVLM, IdeficsVLM]


def _inference(fn):
    """`torch.inference_mode` around a generator method, or `no_grad` for a
    sharded model (`parallel.sharding.shard_params`): `fully_shard`'s
    hooks cannot run on inference tensors."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        sharded = hasattr(self.model, "_shard_layouts")
        with torch.no_grad() if sharded else torch.inference_mode():
            return fn(self, *args, **kwargs)
    return wrapped


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _cache_name(dtype: CacheDtype) -> str:
    if isinstance(dtype, str):
        return dtype
    return "int8" if dtype == torch.int8 else "bf16"


def cache_bytes(text_cfg: TextConfig, batch: int, cache_len: int,
                dtype: CacheDtype) -> int:
    """Device bytes of one KV cache (entries + quantization scales)."""
    rows = batch * text_cfg.num_hidden_layers * text_cfg.kv_heads * cache_len
    name = _cache_name(dtype)
    if name == "int4":   # k and v share a byte
        return rows * text_cfg.head_dim + 2 * 4 * rows
    if name == "int8":
        return 2 * rows * text_cfg.head_dim + 2 * 4 * rows
    return 2 * rows * text_cfg.head_dim * 2


_LADDER = ["bf16", "int8", "int4"]
_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8, "int4": "int4"}


def select_cache_dtype(text_cfg: TextConfig, batch: int, cache_len: int,
                       requested: CacheDtype, *, device: torch.device,
                       param_bytes: int = 0,
                       hbm_bytes: Optional[float] = None,
                       headroom_bytes: Optional[float] = None,
                       also: Tuple[TextConfig, ...] = ()) -> CacheDtype:
    """Degrade-not-die KV-cache precision: when the requested cache does
    not fit next to the resident parameters, step down the ladder
    (bf16 -> int8 -> int4) with a warning instead of failing. The budget
    is `hbm_bytes` (or `OTTER_HBM_BYTES` on CUDA) less the headroom and
    `param_bytes`; on CUDA without either, the card's total memory less
    what live tensors hold (`torch.cuda.memory_allocated`, parameters
    included) and the headroom. Either way the memory pools of the CUDA
    graphs that live entries and batchers hold on `device` count as taken
    (`held_pool_bytes`: their free blocks serve no other tensor). Other
    blocks that torch's caching allocator keeps from freed tensors count
    as free, so the answer does not depend on what ran before.
    `OTTER_HBM_HEADROOM` overrides the 5 GB headroom.
    `also` are the text configs of caches of the same shape and dtype that
    join the footprint (a speculative pool's draft cache). On the CPU
    without `hbm_bytes` the request is returned unchanged."""
    if device.type != "cuda" and hbm_bytes is None:
        return requested
    env_hbm = os.environ.get("OTTER_HBM_BYTES")
    env_head = os.environ.get("OTTER_HBM_HEADROOM")
    if headroom_bytes is None:
        headroom_bytes = float(env_head) if env_head else 5.0e9
    if hbm_bytes is None and env_hbm:
        hbm_bytes = float(env_hbm)
    if hbm_bytes is not None:
        budget = hbm_bytes - headroom_bytes - param_bytes
    else:
        budget = (torch.cuda.mem_get_info(device)[1]
                  - torch.cuda.memory_allocated(device) - headroom_bytes)
    budget -= held_pool_bytes(device)
    name = _cache_name(requested)
    for step in _LADDER[_LADDER.index(name):]:
        if sum(cache_bytes(t, batch, cache_len, step)
               for t in (text_cfg,) + tuple(also)) <= budget:
            if step != name:
                warnings.warn(
                    f"KV cache degraded {name} -> {step}: a b={batch} "
                    f"L={cache_len} {name} cache"
                    f"{' (and the draft pool beside it)' if also else ''}"
                    f" does not fit in "
                    f"{budget / 1e9:.1f} GB of device memory", stacklevel=2)
            return _DTYPES[step]
    warnings.warn(f"KV cache b={batch} L={cache_len} exceeds device memory "
                  f"even at int4; proceeding with int4", stacklevel=2)
    return "int4"


# the holders of captured graphs (an `_Entry`, a batcher's `_PooledGraph`)
# and the device of each: their pools' bytes count as taken memory
_pool_holders: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def hold_pool(holder, device: torch.device) -> None:
    """Count `holder.pool_bytes` as taken on `device` while `holder` lives
    and holds a graph (`holder.graph` not None)."""
    _pool_holders[holder] = torch.device(device)


def held_pool_bytes(device: torch.device) -> int:
    """The bytes of the memory pools that live captured graphs hold on
    `device`: reserved by the caching allocator, not allocated, and no
    other tensor can use them. (A graph's outputs, allocated in its pool,
    also count in `torch.cuda.memory_allocated`: a few kB twice.)"""
    device = torch.device(device)
    same = lambda d: d.type == device.type and (d.index or 0) == (
        device.index or 0)
    return sum(h.pool_bytes or 0 for h, d in list(_pool_holders.items())
               if same(d) and h.graph is not None)


def _on(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.asarray(x)).to(device)


def left_pad(lang_x: np.ndarray, attention_mask: Optional[np.ndarray],
             target_len: Optional[int] = None, pad_id: int = 0):
    """Right-padded (or ragged-masked) batch -> left-padded [B, P]."""
    lang_x = np.asarray(lang_x)
    b, s = lang_x.shape
    if attention_mask is None:
        attention_mask = np.ones_like(lang_x)
    attention_mask = np.asarray(attention_mask)
    p = target_len or s
    out = np.full((b, p), pad_id, lang_x.dtype)
    mask = np.zeros((b, p), np.int32)
    for i in range(b):
        real = lang_x[i][attention_mask[i].astype(bool)]
        out[i, p - len(real):] = real
        mask[i, p - len(real):] = 1
    return out, mask


# the decode loop reads whether every row is done once in this many steps
DONE_EVERY = 8
# entries (a key's tensors and graph) that stay once their requests end: on
# 16 b=1 streams of 6 keys (3 sampling settings, 2 cache lengths) 2 made 9
# captures, 4 the 6 that the keys need, ~100 MiB of pool each (PERF.md)
MAX_ENTRIES = 4
# one CUDA graph capture at a time in a process (torch's rule): engines on
# several threads (a worker's models) take turns
_capture_lock = threading.Lock()


def graph_setting(cuda_graph: Optional[bool], model, draft=None) -> bool:
    """Whether a step over `model` (and, for speculation, its `draft`) is
    captured as a CUDA graph: `None` (the default) where every model is on
    CUDA and none is sharded; True is refused where no graph can run (the
    CPU, a sharded model: `fully_shard`'s hooks gather parameters every
    call)."""
    models = [model] if draft is None else [model, draft]
    what = "model" if draft is None else "model and draft"
    sharded = any(hasattr(m, "_shard_layouts") for m in models)
    on_cuda = all(m.device.type == "cuda" for m in models)
    if cuda_graph is None:
        return on_cuda and not sharded
    if cuda_graph:
        if sharded:
            raise ValueError(f"cuda_graph=True on a sharded {what}: its "
                             f"hooks gather parameters every call")
        if not on_cuda:
            raise ValueError(f"cuda_graph=True needs a CUDA {what}; "
                             f"{'this one is' if draft is None else 'these are'}"
                             f" on {', '.join(str(m.device) for m in models)}")
    return bool(cuda_graph)


class Captured:
    """A captured CUDA graph: the graph, the launches a replay makes
    (`_build.recording_launches`), what the captured call returned (the
    tensors each replay overwrites), the capture's host ms, the bytes its
    memory pool took and the decode_attention workspace it recorded."""

    def __init__(self, graph, launches: dict, out, capture_ms: float,
                 pool_bytes: int, workspace: "da.Workspace"):
        self.graph, self.launches, self.out = graph, launches, out
        self.capture_ms, self.pool_bytes = capture_ms, pool_bytes
        self.workspace = workspace

    def free(self) -> None:
        """Drop the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.out = self.workspace = None


def capture(body, device: torch.device, side: "torch.cuda.Stream",
            workspace: "da.Workspace", generator=None):
    """Run `body()` once eagerly on the stream `side` with `workspace` as
    its decode_attention workspace (so that what it allocates once, the
    workspace and cuBLAS's, exists), then capture it (the capture runs
    nothing), `generator` registered with the graph. Returns (the eager
    call's output, `Captured`). A failure raises. One capture at a time
    in a process (`_capture_lock`)."""
    main = torch.cuda.current_stream(device)
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    try:
        with _capture_lock, torch.cuda.stream(side), \
                da.owned_workspace(workspace):
            out = body()
            workspace.frozen = True
            if generator is not None:
                graph.register_generator_state(generator)
            reserved = torch.cuda.memory_reserved(device)
            t0 = time.perf_counter()
            with _build.recording_launches() as launches:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    g_out = body()
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
            capture_ms = (time.perf_counter() - t0) * 1e3
            pool = torch.cuda.memory_reserved(device) - reserved
    finally:
        main.wait_stream(side)
    return out, Captured(graph, launches, g_out, capture_ms, pool,
                         workspace)


class _DoneFlag:
    """Whether every row of `done` is done, on its way to the host without
    a wait: a copy into pinned memory behind the queued steps. `value()` a
    check later finds it landed (its event waits only for the step that
    made it)."""

    def __init__(self, done: torch.Tensor):
        every = done.all()
        self.event = None
        if done.is_cuda:
            self.host = torch.empty((), dtype=torch.bool, pin_memory=True)
            self.host.copy_(every, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = every

    def value(self) -> bool:
        if self.event is not None:
            self.event.synchronize()
        return bool(self.host)


class _Entry:
    """The decode state of one key, fixed in memory: the tensors a step
    reads and writes in place (`st`: for a greedy / sampled step the
    token, the stacked cache, kv_valid, the buffer, the step counters,
    done and the request's constants; a beam entry adds the search's
    state, `st.beam`), the step (`body`, called with no argument: what a
    graph captures), the decode_attention workspace its graph recorded
    and, once captured, the graph, the launches a replay makes
    (`launches`, from `_build.recording_launches`), the capture's host ms
    and the bytes its memory pool took. A request leases it (`busy`) from
    its prefill to its last token."""

    def __init__(self, key, st: SimpleNamespace, cache_dtype, body):
        self.key, self.st, self.cache_dtype = key, st, cache_dtype
        self.body = body
        self.busy = True
        self.broken = False
        self.workspace = da.Workspace()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: dict = {}
        self.capture_ms: Optional[float] = None
        self.pool_bytes: Optional[int] = None

    def free(self) -> None:
        """Drop the graph, its memory pool and every tensor."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.st = self.workspace = self.body = None


class GraphedSteps:
    """The leases of an engine whose decode step keeps its state on the
    device: entries of fixed tensors, one per key, that a request leases
    from its prefill to its last token; on CUDA each entry's step
    (`_Entry.body`) is captured once as a CUDA graph and replayed
    (`cuda_graph`, `graph_setting`), else run eagerly. At most
    `MAX_ENTRIES` entries stay once their requests end (least recently
    used first out), and requests that run at once each lease their own.
    A capture that fails raises, and its entry is dropped when the request
    ends: no step quietly runs eagerly in place of a replay.
    `OtterGenerator` (greedy, sampled and beam steps),
    `generation.fuyu.FuyuGenerator`, `generation.speculative.
    SpeculativeGenerator` (its round, over a target and a `draft`) and the
    sessions of `generation.session` (each its own) share it."""

    def __init__(self, model, cuda_graph: Optional[bool], draft=None):
        self.model = model
        self.cuda_graph = graph_setting(cuda_graph, model, draft)
        self._entries: List[_Entry] = []   # least recently used first
        self._entries_lock = threading.Lock()
        self._capture_stream = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _evict(self, keep: int) -> None:
        """Free idle entries, least recently used first, until at most
        `keep` entries remain (a busy one is never freed). The caller holds
        `_entries_lock`."""
        for e in [e for e in self._entries if not e.busy]:
            if len(self._entries) <= keep:
                break
            self._entries.remove(e)
            e.free()

    def _take(self, key, make) -> _Entry:
        """An idle entry of `key` (now the most recently used), or `make()`'s
        new one after idle entries beyond `MAX_ENTRIES - 1` are freed;
        marked busy."""
        with self._entries_lock:
            for e in reversed(self._entries):
                if e.key == key and not e.busy:
                    e.busy = True
                    self._entries.remove(e)
                    self._entries.append(e)
                    return e
            self._evict(MAX_ENTRIES - 1)
        entry = make()
        entry.st.entry = entry
        with self._entries_lock:
            self._entries.append(entry)
        return entry

    def close(self) -> None:
        """Free every idle entry: its tensors, graph and memory pool (a
        request that still runs keeps its own until it ends)."""
        with self._entries_lock:
            self._evict(0)

    def _release(self, entry: _Entry) -> None:
        """The request is done with `entry`: it stays (most recently used)
        unless the bound or a failed capture says otherwise."""
        with self._entries_lock:
            entry.busy = False
            if entry in self._entries:
                self._entries.remove(entry)
                if entry.broken:
                    entry.free()
                else:
                    self._entries.append(entry)
            self._evict(MAX_ENTRIES)

    @_inference
    def _advance(self, st: SimpleNamespace) -> None:
        """One decode step of a leased entry's state: the graph's replay
        (its launches added to the counters), or, before the capture, the
        step body (with `cuda_graph`, on the capture stream, and the graph
        captured after it)."""
        entry = st.entry
        if entry.graph is not None:
            entry.graph.replay()
            _build.add_launches(entry.launches)
        elif self.cuda_graph:
            self._capture(entry)
        else:
            entry.body()
        st.t += 1

    def _capture(self, entry: _Entry) -> None:
        """The request's step run once eagerly and captured (`capture`),
        with the entry's own workspace and generator: the step that the
        graph replays from then on. A failure raises and the entry is
        dropped when its request ends."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        try:
            _, cap = capture(entry.body, self.device, self._capture_stream,
                             entry.workspace,
                             getattr(entry.st, "generator", None))
        except BaseException:
            entry.broken = True
            raise
        entry.capture_ms, entry.pool_bytes = cap.capture_ms, cap.pool_bytes
        entry.graph, entry.launches = cap.graph, cap.launches
        hold_pool(entry, self.device)

    def _seed(self, st: SimpleNamespace, generator) -> None:
        """The entry's generator for a sampled request: the request's state
        copied in (`_finish` copies it back), or, without one, a stream of
        its own seeded by one draw from the device's default generator, so
        that requests that run at once draw different numbers."""
        if st.generator is None:
            return
        if generator is not None:
            st.source = generator
            st.generator.set_state(generator.get_state())
        else:
            st.generator.manual_seed(
                int(torch.randint(2 ** 62, (), device=self.device)))

    def _finish(self, st: SimpleNamespace) -> None:
        """The request is done with its entry: the generator it brought
        takes the entry's state (as if it had drawn every number itself)
        and the entry goes back."""
        if st.source is not None:
            st.source.set_state(st.generator.get_state())
            st.source = None
        self._release(st.entry)


class OtterGenerator(GraphedSteps):
    """Greedy / sampled and beam generation over an `OtterVLM` or an
    `IdeficsVLM`, on the model's device.

    The greedy and sampled decode step is the counterpart of the JAX
    engine's compiled step (`jax.jit(self._step, donate_argnums=(2,))`),
    the beam step that of its jitted beam loop (`beam_search`'s
    `lax.fori_loop`): each reads every value that changes from one step
    to the next from device memory (the cache position and the step index
    are counters on the device that the step advances) and makes no host
    sync, and on CUDA it is captured once per key as a CUDA graph
    (`cuda_graph`, on by default there) and replayed. The key is the rows
    (B*K for beams), the cache length and dtype, the vision latents' shape
    and the step's sampling and bans: `gen` less `max_new_tokens` for a
    greedy / sampled step, the whole `gen` for a beam step (its history
    is `max_new_tokens` wide), as the JAX key `("beam", b, p, cache_len,
    gen)` holds it. Each key's tensors live in an entry that the request's
    prefill writes in place (the counterpart of the donated cache;
    `GraphedSteps`). `cuda_graph=False` runs the same step body eagerly
    (the CPU always does: it has no graph). The megakernel and fused-tail
    routes are captured too: the megakernel reads the position from
    device memory."""

    def __init__(self, model: Model,
                 cache_dtype: CacheDtype = torch.bfloat16,
                 hbm_bytes: Optional[float] = None,
                 cuda_graph: Optional[bool] = None):
        super().__init__(model, cuda_graph)
        self.cfg: Union[OtterConfig, IdeficsModelConfig] = model.cfg
        self.cache_dtype = cache_dtype
        self.hbm_bytes = hbm_bytes
        self.param_bytes = sum(t.numel() * t.element_size() for t in
                               list(model.parameters()) + list(model.buffers()))
        self._cache_dtypes: Dict[Tuple[int, int], CacheDtype] = {}

    def _cache_dtype_for(self, b: int, cache_len: int) -> CacheDtype:
        """The cache dtype for this (batch, cache_len): the requested one,
        degraded down the ladder when it would not fit
        (`select_cache_dtype`) beside the parameters and the caches the
        entries hold, chosen once per key so that equal requests get equal
        caches."""
        key = (b, cache_len)
        if key not in self._cache_dtypes:
            with self._entries_lock:
                held = sum(cache_bytes(self.cfg.text, *e.key[:2],
                                       e.cache_dtype) for e in self._entries)
            self._cache_dtypes[key] = select_cache_dtype(
                self.cfg.text, b, cache_len, self.cache_dtype,
                device=self.device, param_bytes=self.param_bytes + held,
                hbm_bytes=self.hbm_bytes)
        return self._cache_dtypes[key]

    # ── the entries ──────────────────────────────────────────────────

    def _lease(self, rows: int, cache_len: int, vis_latents: torch.Tensor,
               gen: GenerationConfig) -> _Entry:
        """An idle entry of this request's key, or a new one (after idle
        entries beyond `MAX_ENTRIES - 1` are freed), marked busy."""
        if (rows, cache_len) not in self._cache_dtypes:
            # a new shape: free room first, so that the cache ladder counts
            # only the entries that stay
            with self._entries_lock:
                self._evict(MAX_ENTRIES - 1)
        dtype = self._cache_dtype_for(rows, cache_len)
        step_gen = (gen if gen.num_beams > 1
                    else dataclasses.replace(gen, max_new_tokens=0))
        key = (rows, cache_len, _cache_name(dtype), tuple(vis_latents.shape),
               step_gen)

        def make():
            st = self._new_state(rows, cache_len, dtype, vis_latents,
                                 step_gen)
            if gen.num_beams > 1:
                return _Entry(key, st, dtype,
                              lambda: beam._beam_step(st.beam))
            return _Entry(key, st, dtype, lambda: self._step_body(st))
        return self._take(key, make)

    def _new_state(self, rows: int, cache_len: int, dtype: CacheDtype,
                   vis_latents: torch.Tensor,
                   gen: GenerationConfig) -> SimpleNamespace:
        """An entry's tensors, to be filled by each request's prefill."""
        dev = self.device
        long = dict(dtype=torch.long, device=dev)
        return SimpleNamespace(
            gen=gen,
            eos=(gen.eos_token_id if gen.eos_token_id is not None
                 else self.cfg.eoc_token_id),
            # (a tensor-parallel model keeps its rank's kv heads)
            cache=init_cache(self.cfg.text, rows, cache_len, dtype, dev,
                             kv_heads=getattr(self.model, "tp_kv_heads",
                                              None)),
            tok=torch.zeros(rows, **long),
            buffer=torch.zeros((rows, cache_len), **long),
            kv_valid=torch.zeros((rows, cache_len), dtype=torch.bool,
                                 device=dev),
            done=torch.zeros(rows, dtype=torch.bool, device=dev),
            # tokens sampled so far, and the prompt's width
            t_dev=torch.zeros((), **long), p_dev=torch.zeros((), **long),
            real_len=(None if self.cfg.text.pos == "alibi"
                      else torch.zeros(rows, **long)),
            valid_from=torch.zeros(rows, **long),
            media_counts=torch.zeros(rows, **long),
            vis_latents=torch.empty_like(vis_latents),
            # the entry's own generator, registered with its graph; a
            # request's generator state is copied in and out (`_prefill`,
            # `_finish`)
            generator=(torch.Generator(device=dev)
                       if gen.do_sample and gen.num_beams <= 1 else None),
            # a beam entry's search state (`_beam_prefill`)
            beam=None, source=None, p=0, t=0, logits=None)

    # ── prefill and the step ─────────────────────────────────────────

    @_inference
    def _prefill(self, vision_x, lang_x, attention_mask,
                 gen: GenerationConfig, generator=None, vision_mask=None,
                 beams: int = 1) -> SimpleNamespace:
        """Encode the vision input, prefill the cache and sample the first
        token: the state that `_advance` steps, a leased entry's (`st.entry`;
        `_finish` returns it). With `beams` K > 1 every request becomes K
        rows (row i*K + j is beam j of request i; the vision input encoded
        once, its latents repeated) and nothing is sampled: `st.logits`
        holds each request's first logits [B, V]."""
        dev = self.device
        lang_x = _on(lang_x, dev).long()
        b, p = lang_x.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, p), dtype=torch.int32, device=dev)
        attention_mask = _on(attention_mask, dev).int()
        vis_latents = self.model.encode_vision(
            _on(vision_x, dev),
            None if vision_mask is None else _on(vision_mask, dev).bool())
        if beams > 1:
            lang_x, attention_mask, vis_latents = (
                x.repeat_interleave(beams, 0)
                for x in (lang_x, attention_mask, vis_latents))
        rows = b * beams
        cache_len = _round_up(p + gen.max_new_tokens, 128)
        # a token's position counts the real tokens before it: left padding
        # does not move a prompt (ALiBi takes no positions)
        real_len = positions = None
        if self.cfg.text.pos != "alibi":
            real_len = attention_mask.sum(-1)
            positions = (attention_mask.cumsum(-1) - 1).clamp_min(0)
        values = dict(
            vis_latents=vis_latents, real_len=real_len,
            media_counts=(lang_x == self.cfg.media_token_id).int().sum(-1),
            valid_from=p - attention_mask.sum(-1),
            buffer=torch.cat([lang_x, torch.full(
                (rows, cache_len - p), gen.pad_token_id, dtype=torch.long,
                device=dev)], dim=1),
            kv_valid=torch.cat([attention_mask.bool(), torch.zeros(
                (rows, cache_len - p), dtype=torch.bool, device=dev)], dim=1))
        st = self._lease(rows, cache_len, vis_latents, gen).st
        try:
            logits, _, _ = self.model(
                None, lang_x, attention_mask=attention_mask,
                positions=positions, vis_latents=vis_latents,
                head_last_only=True, cache=st.cache)
            for name, val in values.items():
                if val is not None:
                    getattr(st, name).copy_(val)
            st.t_dev.zero_()
            st.p_dev.fill_(p)
            st.p, st.t = p, 0
            if beams > 1:
                st.logits = logits[::beams, -1]
                return st
            st.done.zero_()
            self._seed(st, generator)
            self._sample(st, logits[:, -1])
            st.t = 1
        except BaseException:
            self._finish(st)
            raise
        return st

    def _sample(self, st: SimpleNamespace, logits: torch.Tensor) -> None:
        """Token t of every row from its logits (pad once the row is
        done), written to the buffer at p + t; t advances. Reads t and p
        from their device counters. `st.logits` keeps the logits (a
        graph's replays write them in place)."""
        gen = st.gen
        st.logits = logits
        cur = st.p_dev + st.t_dev
        logits = sampling.process_logits(logits, st.buffer, cur, gen,
                                         st.valid_from)
        tok = sampling.sample_token(
            logits, do_sample=gen.do_sample, temperature=gen.temperature,
            top_k=gen.top_k, top_p=gen.top_p, generator=st.generator)
        tok = torch.where(st.done, gen.pad_token_id, tok)
        st.tok.copy_(tok)
        st.done.logical_or_(tok == st.eos)
        st.buffer.index_copy_(1, cur.view(1), tok[:, None])
        st.t_dev.add_(1)

    def _step_body(self, st: SimpleNamespace) -> None:
        """One cached decode step on the entry's tensors, in place: feed
        token t - 1 at cache position p + t - 1, sample token t. The
        position and the step index come from the device counters, so the
        same call serves every step: what a graph captures."""
        t = st.t_dev
        pos = st.p_dev + t - 1
        st.kv_valid.index_fill_(1, pos.view(1), True)
        positions = (None if st.real_len is None
                     else (st.real_len + (t - 1))[:, None])
        logits, _, _ = self.model(
            None, st.tok[:, None], vis_latents=st.vis_latents,
            cache=st.cache, cache_pos=pos, kv_valid=st.kv_valid,
            positions=positions, media_counts=st.media_counts)
        self._sample(st, logits[:, -1])

    def generate(self, vision_x, lang_x, attention_mask=None,
                 gen: Optional[GenerationConfig] = None,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """vision_x [B,T,F,C,H,W] float pixels ([B,N,C,H,W] for
        idefics); lang_x [B,P] LEFT-padded
        (see `left_pad`). Returns [B, P + max_new_tokens] (prompt +
        generation, eos-terminated, pad-filled). num_beams > 1 runs beam
        search and returns the best beam of each row."""
        gen = gen or GenerationConfig()
        if gen.num_beams > 1:
            return self._beam_generate(vision_x, lang_x, attention_mask, gen)
        st = self._prefill(vision_x, lang_x, attention_mask, gen, generator)
        try:
            self._decode(st, gen.max_new_tokens)
            # a copy on the CPU too: the entry's buffer serves the next
            # request
            return st.buffer[:, : st.p + gen.max_new_tokens].to(
                "cpu", copy=True).numpy()
        finally:
            self._finish(st)

    def _decode(self, st: SimpleNamespace, until: int) -> None:
        """`generate`'s decode loop: steps until `until` tokens are sampled
        or every row is done, as the JAX loop's condition (`t < max_new &
        ~all(done)`). The host reads `done` once every DONE_EVERY steps,
        from a copy made DONE_EVERY steps before (so at most 2 * DONE_EVERY
        - 1 steps past the last row's end, which write pad where pad is)."""
        flag = None
        while st.t < until:
            if (st.t - 1) % DONE_EVERY == 0:
                if flag is not None and flag.value():
                    return
                flag = _DoneFlag(st.done)
            self._advance(st)

    def stream_generate(self, vision_x, lang_x, attention_mask=None,
                        gen: Optional[GenerationConfig] = None,
                        generator: Optional[torch.Generator] = None,
                        vision_mask=None) -> Iterator[int]:
        """One request (batch 1): yields each token id as it is sampled,
        with `generate`'s sampling and bans, and stops at eos (not
        yielded) or after max_new_tokens: a step, then its token read, as
        the JAX loop reads `int(tok[0])`. `vision_mask` [1, T, F] bool
        marks the real frames of mixed still+video media. Greedy or
        sampled only, as the JAX engine's: beams stream through
        `stream_beam_generate`."""
        gen = gen or GenerationConfig()
        if np.shape(lang_x)[0] != 1:
            raise ValueError("stream_generate serves one request; batch "
                             "with generate")
        st = self._prefill(vision_x, lang_x, attention_mask, gen, generator,
                           vision_mask)
        try:
            while True:
                tok = int(st.tok[0])
                if tok == st.eos:
                    return
                yield tok
                if st.t >= gen.max_new_tokens:
                    return
                self._advance(st)
        finally:
            self._finish(st)

    # ── beam search ──────────────────────────────────────────────────

    @_inference
    def _beam_prefill(self, vision_x, lang_x, attention_mask,
                      gen: GenerationConfig) -> SimpleNamespace:
        """The prefill of B*K rows into a leased beam entry, and the
        search's state after the first token (`st.beam`, made at the
        entry's first request): the state that `_advance` steps, one beam
        step a call (`beam._beam_step`)."""
        k = gen.num_beams
        st = self._prefill(vision_x, lang_x, attention_mask, gen, beams=k)
        try:
            if st.beam is None:
                st.beam = self._beam_state(st, k)
            p = st.p
            beam._beam_setup(st.beam, sampling.process_logits(
                st.logits, st.buffer[::k, :p], p, gen, st.valid_from[::k]))
            st.t = 1
        except BaseException:
            self._finish(st)
            raise
        return st

    def _beam_state(self, st: SimpleNamespace, k: int) -> SimpleNamespace:
        """A beam entry's search state, sharing the entry's step counter:
        its step and bans read the cache position p + t - 1 and the bans'
        end p + t from the counters `st.p_dev` and `st.t_dev`."""
        gen, dev = st.gen, self.device
        rows, width = st.buffer.shape
        cols = torch.arange(width, device=dev)[None]
        history = torch.arange(gen.max_new_tokens, device=dev)

        def step_fn(tok, cache, t):
            # as the JAX engine's beam step: every slot below p + t is
            # attended, the prompt's left padding too (ROADMAP Queue 3)
            pos = st.p_dev + t - 1
            positions = (None if st.real_len is None
                         else (st.real_len + (t - 1))[:, None])
            logits, cache, _ = self.model(
                None, tok, vis_latents=st.vis_latents, cache=cache,
                cache_pos=pos, kv_valid=st.kv_valid | (cols <= pos),
                positions=positions, media_counts=st.media_counts)
            return logits[:, -1], cache

        def logits_processor(logits, gen_tokens, t):
            # the left-padded prompt before the beam's tokens (the buffer:
            # the prompt, then the history written at p), so the bans see
            # the whole context, as HF's processors do
            st.buffer.index_copy_(1, st.p_dev + history, gen_tokens)
            return sampling.process_logits(logits, st.buffer, st.p_dev + t,
                                           gen, st.valid_from)

        bans = gen.no_repeat_ngram_size or gen.bad_words_ids
        return beam._beam_state(
            rows // k, st.logits.shape[-1], num_beams=k,
            max_new_tokens=gen.max_new_tokens, eos_token_id=st.eos,
            pad_token_id=gen.pad_token_id, length_penalty=gen.length_penalty,
            step_fn=step_fn, logits_processor=logits_processor if bans
            else None, cache=st.cache, device=dev, t_dev=st.t_dev)

    @_inference
    def _beam_generate(self, vision_x, lang_x, attention_mask,
                       gen: GenerationConfig) -> np.ndarray:
        st = self._beam_prefill(vision_x, lang_x, attention_mask, gen)
        try:
            for _ in range(1, gen.max_new_tokens):
                self._advance(st)
            out, _ = beam._beam_best(st.beam)
            return torch.cat([st.buffer[::gen.num_beams, :st.p], out],
                             dim=1).cpu().numpy()
        finally:
            self._finish(st)

    def stream_beam_generate(self, vision_x, lang_x, attention_mask=None,
                             gen: Optional[GenerationConfig] = None,
                             chunk: int = 4) -> Iterator[list]:
        """Beam search for one request, streamed: yields the current best
        beam's tokens (up to eos) every `chunk` steps; the last yield is
        `generate(num_beams=K)`'s continuation. A later yield may revise
        earlier tokens (the serving protocol re-renders the whole text).
        The steps are `generate`'s (replays of the key's graph on CUDA);
        a stream closed early gives its entry back."""
        gen = gen or GenerationConfig()
        if np.shape(lang_x)[0] != 1:
            raise ValueError("stream_beam_generate serves one request; "
                             "batch with generate")
        st = self._beam_prefill(vision_x, lang_x, attention_mask, gen)
        try:
            for first, end in beam._chunks(gen.max_new_tokens, chunk):
                for _ in range(first, end):
                    self._advance(st)
                toks = []
                for x in beam._beam_best(st.beam)[0][0, :end].tolist():
                    if x == st.eos:
                        break
                    toks.append(x)
                yield toks
        finally:
            self._finish(st)
