"""Continuous batching (counterpart of `otter_tpu/generation/batching.py`,
without its speculative modes): many concurrent streaming requests share
one decode step over a fixed pool of batch slots.

A request is admitted into a free slot by a single-row prefill at a
bucketed length, its KV cache copied into the pooled cache; then one
decode step advances every active slot per iteration, so that the card
serves several users for about the price of one (a step is host-bound).

  - per-row cache offsets: each slot has its own length; the decoder's
    `[B]` `cache_pos` writes the new KV at `written[slot]`
  - per-row sampling: temperature / top-k / top-p / eos are `[B]` tensors
    of one sampler (`sampling.sample_rows`)
  - sequence-aware bans (no_repeat_ngram / bad_words) run once per
    distinct configuration among the active slots, row-gated, against the
    pooled token buffer on the device
  - beam requests hold `num_beams` slots in lockstep (`_BeamGroup`)
  - long prompts prefill in chunks, one chunk after each decode iteration
    (`prefill_chunk`)

Every launch goes from the scheduler thread, on the device's current
stream. The slot state that one iteration hands the next (tokens, alive,
written, emitted) stays on the device, and iteration t's tokens come back
by a non-blocking copy into pinned memory and an event while iteration
t + 1 is already queued, so the host waits on nothing before it queues
the next step. A first token reaches its stream through the finisher
thread, which waits on the token's event, never on the device as a whole.

With a draft model (`draft=`) every iteration is a speculative round over
the whole pool (`_spec_round`): the draft's s=2 opener and gamma-1 steps,
each one pooled call with per-row offsets, then one s=gamma+1 verify window
of the target, and a per-row accept that commits 1..gamma+1 tokens a row.
Greedy rows emit the target's greedy tokens exactly; sampled rows follow
the rejection rule (`speculative.accept_resample_rows`), which is exact for
any proposal. A round hands the next one its slot state on the device, and
its (tokens, counts) come back by one non-blocking copy, as a plain step's
do. The adaptive controller (`spec_adaptive`) times iterations on the
host's clock after their readbacks and picks among gamma, gamma // 2 and
plain decode by the measured tokens a second, down to plain decode below
break-even; a switch back from plain decode first re-ingests the columns
that the draft missed (`_run_catchup`). Beam requests in a speculative pool
run as num_beams=1: a beam revises its past, which a cache that never
rolls back cannot.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import warnings
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from otter_tpu_torch.config import GenerationConfig
from otter_tpu_torch.generation import sampling
from otter_tpu_torch.generation.beam import _top_k
from otter_tpu_torch.generation.engine import _on, left_pad, \
    select_cache_dtype
from otter_tpu_torch.generation.speculative import accept_resample_rows
from otter_tpu_torch.models.decoder import init_cache
from otter_tpu_torch.models.idefics import IdeficsVLM
from otter_tpu_torch.ops.masks import media_attention_ids

def _round_bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket "
                     f"{buckets[-1]}")


def _param_bytes(model: torch.nn.Module) -> int:
    return sum(t.numel() * t.element_size() for t in
               list(model.parameters()) + list(model.buffers()))


def autotune_num_slots(model, cache_len: int, cache_dtype, *,
                       hbm_bytes: Optional[float] = None,
                       headroom_bytes: float = 1.5e9,
                       max_slots: int = 32, draft=None) -> int:
    """The largest slot pool whose KV cache fits the memory budget beside
    the resident parameters: (budget - parameters - headroom) // the bytes
    of one cache row (k and v and, for a quantized cache, their scales),
    clamped to [1, max_slots]. The budget is `hbm_bytes`, else
    `OTTER_HBM_BYTES`, else the card's total memory; on the CPU one of the
    first two must be given. With a `draft` model (slot-pool speculation)
    its parameters and its cache row join the footprint."""
    if hbm_bytes is None and os.environ.get("OTTER_HBM_BYTES"):
        hbm_bytes = float(os.environ["OTTER_HBM_BYTES"])
    if hbm_bytes is None:
        if model.device.type != "cuda":
            raise ValueError("autotune_num_slots on the CPU needs hbm_bytes "
                             "or OTTER_HBM_BYTES")
        hbm_bytes = float(torch.cuda.mem_get_info(model.device)[1])
    models = [model] if draft is None else [model, draft]
    row_bytes = sum(
        t.numel() * t.element_size() for m in models
        for t in init_cache(m.cfg.text, 1, cache_len, cache_dtype,
                            device="meta").values())
    free = hbm_bytes - sum(map(_param_bytes, models)) - headroom_bytes
    return max(1, min(max_slots, int(free // max(row_bytes, 1))))


class _SchedulerError:
    """Sentinel delivered on every stream queue when the scheduler thread
    dies; the stream re-raises it on the consumer's thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


@dataclass
class _Slot:
    active: bool = False
    pending: bool = False   # admitted, first token not yet on the host:
    #                         out of the decode pool, not free either
    gen: Optional[GenerationConfig] = None
    out: Optional[queue.Queue] = None
    real_len: int = 0       # true prompt tokens (pads excluded)
    bucket: int = 0         # prefill bucket = first decode write column
    written: int = 0        # next cache column to write
    emitted: int = 0        # generated tokens so far
    media: int = 0          # media tokens in the prompt
    last_tok: int = 0
    group: Optional[int] = None   # beam-group id (num_beams > 1)
    t_submit: float = 0.0   # request enqueued
    t_admit: float = 0.0    # first token available
    t_first: float = 0.0    # first token delivered
    # speculation: an EMA of the tokens a round committed for this slot
    accept_ema: Optional[float] = None


@dataclass
class _BeamGroup:
    """One num_beams > 1 request holding `rows` slots in lockstep: the
    shared decode step advances every beam row like any other slot, then a
    top-2k candidate pass over the group's rows (HF beam semantics, as
    `generation/beam.py`) reorders their cache, buffer and valid rows to
    the chosen parent beams. The tokens are delivered when the search
    ends (a beam may revise earlier tokens, which a token stream cannot
    express)."""
    gen: GenerationConfig
    out: queue.Queue
    rows: List[int] = field(default_factory=list)
    gid: int = -1
    scores: Any = None                   # live beam scores, np [k] f32
    hyps: List[List[int]] = field(default_factory=list)   # live tokens
    fin: List[Tuple[float, List[int]]] = field(default_factory=list)
    t_submit: float = 0.0


class ContinuousBatcher:
    """Slot-pool streaming engine over an `OtterVLM` or an `IdeficsVLM`
    on its device. `submit()` is thread-safe and returns an iterator of
    token ids; a scheduler thread runs every request through one decode
    step per iteration (a speculative round with a `draft` model: an
    `OtterVLM` of the target's vocabulary)."""

    def __init__(self, model, *, num_slots=4, cache_len: int = 2048,
                 buckets: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024),
                 max_media: int = 1, cache_dtype=torch.bfloat16,
                 rng_seed: int = 0, max_admits_per_iter: int = 1,
                 hbm_bytes: Optional[float] = None, prefill_chunk: int = 0,
                 draft=None, spec_gamma: int = 4,
                 spec_adaptive: bool = True):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.model_d = draft
        self.gamma = spec_gamma
        if draft is not None:
            if draft.cfg.text.vocab_size != self.cfg.text.vocab_size:
                raise ValueError("slot-pool speculation needs one "
                                 "vocabulary")
            if max(buckets) + spec_gamma + 1 > cache_len:
                raise ValueError("cache_len must leave a gamma+1 verify "
                                 "window after the largest prompt bucket")
        # columns a live row needs past its next write: a round writes
        # gamma+1 from it, so in a speculative pool plain steps stop a row
        # at the same bound and no round ever passes the cache's end
        self._room = 1 if draft is None else spec_gamma + 1
        # degrade-not-die: a pool that does not fit the card drops its
        # cache precision a step (bf16 -> int8 -> int4, with a warning);
        # the draft's cache counts and takes the same dtype
        if num_slots != "auto":
            cache_dtype = select_cache_dtype(
                self.cfg.text, num_slots, cache_len, cache_dtype,
                device=self.device,
                param_bytes=_param_bytes(model) + (
                    _param_bytes(draft) if draft is not None else 0),
                hbm_bytes=hbm_bytes,
                also=() if draft is None else (draft.cfg.text,))
        else:
            num_slots = autotune_num_slots(model, cache_len, cache_dtype,
                                           hbm_bytes=hbm_bytes, draft=draft)
        self.n = num_slots
        self.L = cache_len
        self.buckets = tuple(sorted(buckets))
        self.max_media = max_media
        self.cache_dtype = cache_dtype
        # a prefill stalls every active stream for an iteration: while
        # anything decodes, at most this many admissions per iteration
        self.max_admits_per_iter = max_admits_per_iter
        # chunked prefill: buckets above the chunk (and divisible by it)
        # prefill C tokens at a time, one chunk after each decode step
        if prefill_chunk:
            if isinstance(model, IdeficsVLM):
                raise ValueError("prefill_chunk: chunked prefill passes "
                                 "the prompt's media ids to OtterVLM "
                                 "(xattn_ids); IdeficsVLM takes none")
            eligible = [b for b in buckets
                        if b > prefill_chunk and b % prefill_chunk == 0]
            skipped = [b for b in buckets
                       if b > prefill_chunk and b % prefill_chunk != 0]
            if not eligible:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} divides none of the "
                    f"buckets {buckets} — chunking would silently never "
                    f"activate; pick a chunk that divides the long "
                    f"buckets (e.g. a power of two)")
            if skipped:
                warnings.warn(
                    f"prefill_chunk={prefill_chunk}: buckets {skipped} "
                    f"are not divisible and will use one-shot prefill")
        self.prefill_chunk = prefill_chunk
        self._chunk_tasks: List[dict] = []    # admissions mid-prefill
        self._ready_chunked: List[dict] = []  # all chunks dispatched
        self._completed: List[dict] = []      # per-request latency records

        self._slots = [_Slot() for _ in range(num_slots)]
        self._groups: Dict[int, _BeamGroup] = {}
        self._next_group = 0
        self._deferred: List[tuple] = []   # beam requests awaiting k slots
        self._pending: "queue.Queue[tuple]" = queue.Queue()
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(rng_seed)
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = False
        self._failure: Optional[BaseException] = None

        # pooled device state
        self._cache = init_cache(self.cfg.text, num_slots, cache_len,
                                 cache_dtype, self.device)
        self._buffer = torch.zeros((num_slots, cache_len), dtype=torch.long,
                                   device=self.device)
        self._valid = torch.zeros((num_slots, cache_len), dtype=torch.bool,
                                  device=self.device)
        self._latents: Optional[torch.Tensor] = None  # lazy: latent dims
        # the draft's pools: its cache mirrors the target's column layout
        # (the same buffer and valid rows), so only the cache and the
        # latents are its own
        if draft is not None:
            self._cache_d = init_cache(draft.cfg.text, num_slots, cache_len,
                                       cache_dtype, self.device)
            self._latents_d: Optional[torch.Tensor] = None

        # the acceptance-adaptive controller: a round's time at one gamma
        # does not depend on what it accepts, so spec(g) beats plain decode
        # iff E[tokens a round] > T_spec(g) / T_plain. EMAs of the tokens a
        # round at each gamma and of the seconds an iteration in each mode;
        # the modes without a measurement are probed; the fastest wins by
        # 5%. Every mode emits the same tokens (greedy rows exactly,
        # sampled rows in distribution): probing costs time, never output
        self.spec_adaptive = bool(spec_adaptive and draft is not None)
        self._mode_now: Any = ("spec", spec_gamma)
        self._probe_plan: List[Any] = []
        self._accept_ema: Dict[int, float] = {}    # gamma -> tokens a round
        self._iter_times: Dict[Any, float] = {}    # mode -> s an iteration
        self._t_last_iter: Optional[float] = None
        self._last_mode: Any = None
        self._ctrl_count = 0
        self._stale_count = 0      # iterations since suspended modes probed
        self._draft_stale = False  # the draft's cache missed committed tokens
        self._clock = time.monotonic
        # the controller's cadence (attributes, so tests can shrink them)
        self._replan_every = 32    # drained iterations between decisions
        self._probe_len = 8        # iterations a probe of one mode
        self._stale_every = 1024   # refresh the suspended modes' estimates
        # the catch-up re-ingests at most this many of a row's last columns
        # (and never past the cache's end: see `_run_catchup`)
        self._catchup_w = min(256, cache_len - max(self.buckets))

        # pipelined decode: carried slot state on the device, and the
        # iterations whose tokens are still on their way to the host
        self.pipeline_depth = 1
        self._carried: Optional[Dict[str, torch.Tensor]] = None
        self._statics: Optional[Dict[str, torch.Tensor]] = None
        self._lp_list: Tuple = ()
        self._dirty = True
        self._inflight: List[tuple] = []

        # admission finisher: waits for each first token off the
        # scheduler thread; the slot joins the decode pool (pending ->
        # active) when its token lands in `_finished`
        self._force_q: "queue.Queue[tuple]" = queue.Queue()
        self._finished: List[tuple] = []
        self._finisher = threading.Thread(target=self._force_loop,
                                          daemon=True)
        self._finisher.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ── public API ────────────────────────────────────────────────────

    def submit(self, vision_x, lang_x,
               gen: Optional[GenerationConfig] = None):
        """Enqueue one request (vision_x [1, T, F, C, H, W] or, for
        idefics, [1, N, C, H, W]; lang_x [1, S]); yields the generated
        token ids (eos excluded).

        num_beams > 1 runs beam search inside the pool (the request holds
        num_beams slots) and delivers the best hypothesis's tokens when
        it ends. num_beams is capped at the pool size. A request with more
        media than `max_media` is refused here: the pool holds that many
        latents a slot."""
        gen = gen or GenerationConfig()
        if self.model_d is not None and gen.num_beams > 1:
            # a beam revises its past, which a speculative pool's cache
            # (never rolled back) cannot: such a request runs greedy
            gen = replace(gen, num_beams=1)
        if gen.num_beams > self.n:
            gen = replace(gen, num_beams=self.n)
        vision_x = np.asarray(vision_x)
        media = (int(np.prod(vision_x.shape[1:-3]))
                 if isinstance(self.model, IdeficsVLM) else vision_x.shape[1])
        if media > self.max_media:
            raise ValueError(f"{media} media in a request; the pool holds "
                             f"max_media={self.max_media} a slot")
        out: "queue.Queue" = queue.Queue()
        # under the lock that `_fail_streams` takes: a request either
        # sees the failure here or is failed with the others
        with self._lock:
            if self._failure is not None:
                raise RuntimeError(
                    "ContinuousBatcher scheduler thread has failed"
                ) from self._failure
            self._pending.put((vision_x, np.asarray(lang_x), gen, out,
                               time.monotonic()))
        self._work.set()

        def stream():
            while True:
                tok = out.get()
                if tok is None:
                    return
                if isinstance(tok, _SchedulerError):
                    raise RuntimeError(
                        "ContinuousBatcher scheduler thread failed; "
                        "stream aborted") from tok.exc
                yield tok

        return stream()

    def shutdown(self):
        self._stop = True
        self._work.set()
        self._thread.join(timeout=10)
        self._finisher.join(timeout=10)

    def active_count(self) -> int:
        with self._lock:
            return (sum(s.active or s.pending for s in self._slots)
                    + self._pending.qsize())

    def stats(self) -> dict:
        """Queue depth, active slots, and percentiles over the completed
        requests' latency records."""
        with self._lock:
            records = list(self._completed)
            active = sum(s.active for s in self._slots)
        out = {
            "active_slots": active,
            "num_slots": self.n,
            "queue_depth": self._pending.qsize(),
            "completed": len(records),
        }
        if records:
            ttfts = sorted(r["ttft_s"] for r in records)
            rates = sorted(r["decode_tok_s"] for r in records)

            def pct(xs, p):
                return xs[min(len(xs) - 1, int(p * len(xs)))]

            out.update({
                "ttft_p50_s": pct(ttfts, 0.5),
                "ttft_p90_s": pct(ttfts, 0.9),
                "decode_tok_s_p50": pct(rates, 0.5),
                "recent": records[-8:],
            })
        if self.model_d is not None:
            name = lambda m: "plain" if m == "plain" else f"spec_gamma{m[1]}"
            out["spec"] = {
                "adaptive": self.spec_adaptive,
                "mode": name(self._mode_now),
                "accept_ema_tok_per_round": dict(self._accept_ema),
                "iter_time_ema_s": {name(m): t for m, t
                                    in self._iter_times.items()},
                "slot_accept_ema": [s.accept_ema for s in self._slots],
            }
        return out

    # ── device <-> host ───────────────────────────────────────────────

    def _dev(self, values, dtype) -> torch.Tensor:
        """Host values as a tensor on the device, copied without waiting
        for the work queued before it."""
        t = torch.tensor(values, dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _to_host(self, t: torch.Tensor):
        """(host tensor, event): a copy of `t` that is complete once the
        event is (no event on the CPU)."""
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    @staticmethod
    def _host_values(copy) -> np.ndarray:
        host, event = copy
        if event is not None:
            event.synchronize()
        return host.numpy()

    # ── the finisher ──────────────────────────────────────────────────

    def _force_loop(self):
        """Finisher thread: waits for each admitted first token off the
        scheduler's path. A failure there (a device error surfaces where
        the host waits) fails every stream, as the scheduler's does."""
        try:
            while not self._stop and self._failure is None:
                try:
                    slot, copy = self._force_q.get(timeout=0.2)
                except queue.Empty:
                    continue
                tok = int(self._host_values(copy)[0])
                with self._lock:
                    self._finished.append((slot, tok))
                self._work.set()
        except Exception as e:   # noqa: BLE001 - delivered to every stream
            self._fail_streams(e)
            self._work.set()

    def _collect_admitted(self):
        """Scheduler half of an admission: move slots whose first token
        landed into the decode pool (in-flight iterations drained)."""
        with self._lock:
            done, self._finished = self._finished, []
        for slot, tok in done:
            slot.pending = False
            slot.active = True
            self._admit_finish_slot(slot, tok)
            self._dirty = True

    # ── device pieces ─────────────────────────────────────────────────

    @torch.no_grad()
    def _prefill(self, vision_x, ids, mask, bucket: int, model=None):
        """One request's prefill at its bucket through `model` (the
        target's by default): (last logits [1, V], its cache, vision
        latents)."""
        model = model or self.model
        cache = init_cache(model.cfg.text, 1, bucket, self.cache_dtype,
                           self.device)
        positions = (mask.cumsum(-1) - 1).clamp_min(0)
        logits, cache, lat = model(
            _on(vision_x, self.device), ids, attention_mask=mask,
            positions=positions, cache=cache, head_last_only=True)
        return logits[:, -1], cache, lat

    def _insert(self, slot: int, small, bucket: int, ids_row, mask_row,
                lat):
        """A prefilled cache, its ids, valid row and latents into `slot`."""
        if self._latents is None:
            self._latents = torch.zeros(
                (self.n, self.max_media) + tuple(lat.shape[2:]),
                dtype=lat.dtype, device=self.device)
        for key, big in self._cache.items():
            big[slot, :, :, :bucket] = small[key][0]
        self._buffer[slot, :bucket] = ids_row
        self._valid[slot] = False
        self._valid[slot, :bucket] = mask_row.bool()
        self._latents[slot, :lat.shape[1]] = lat[0]

    def _admit_draft(self, vision_x, ids, mask, bucket: int, slot: int):
        """The draft's half of an admission: its prefill of the same padded
        prompt, its cache and latents into the draft's pools (the target's
        insert wrote the shared buffer and valid rows). Its logits go
        unused: a round opens from the target's first token."""
        _, small, lat = self._prefill(vision_x, ids, mask, bucket,
                                      self.model_d)
        if self._latents_d is None:
            self._latents_d = torch.zeros(
                (self.n, self.max_media) + tuple(lat.shape[2:]),
                dtype=lat.dtype, device=self.device)
        for key, big in self._cache_d.items():
            big[slot, :, :, :bucket] = small[key][0]
        self._latents_d[slot, :lat.shape[1]] = lat[0]

    def _first_token(self, logits, ids, bucket: int, real: int,
                     gen: GenerationConfig) -> torch.Tensor:
        """A request's first token [1] from its prefill logits, on the
        device: greedy unless sampled at a temperature above 0."""
        if gen.no_repeat_ngram_size or gen.bad_words_ids:
            logits = sampling.process_logits(logits, ids, bucket, gen,
                                             bucket - real)
        sampled = gen.do_sample and gen.temperature != 0.0
        return sampling.sample_rows(
            logits, do_sample=self._dev([sampled], torch.bool),
            temperature=self._dev(
                [gen.temperature if sampled else 1.0], torch.float32),
            top_k=self._dev([gen.top_k], torch.long),
            top_p=self._dev([gen.top_p], torch.float32),
            generator=self._rng)

    @torch.no_grad()
    def _decode_step(self, ca: Dict[str, torch.Tensor],
                     st: Dict[str, torch.Tensor],
                     lp_configs: Tuple[Tuple[int, Any], ...],
                     need_logits: bool = False):
        """One cached step of every slot. `lp_configs`: the distinct
        (ngram, bad_words_ids) among active slots, each row picking its own
        by `st["lp_idx"]` (-1: none). Returns (next tokens, alive, written,
        emitted) for the next iteration and, with `need_logits`, the
        processed logits [n, V] (beam groups select from them)."""
        toks, alive, written, emitted = (ca["toks"], ca["alive"],
                                         ca["written"], ca["emitted"])
        L = self.L
        cols = torch.arange(L, device=self.device)[None, :]
        kv_valid = self._valid | (cols == written[:, None])
        positions = (st["real_len"] + emitted - 1).clamp_min(0)[:, None]
        # a finished row that filled the cache holds written == L: its
        # write goes to the last column instead (the JAX scatter drops
        # it); the row's cache and valid row are rewritten at its next
        # admission
        at = written.clamp_max(L - 1)
        logits, _, _ = self.model(
            None, toks[:, None], vis_latents=self._latents, cache=self._cache,
            cache_pos=at, kv_valid=kv_valid, positions=positions,
            media_counts=st["media"])
        logits = logits[:, -1]
        self._buffer[torch.arange(self.n, device=self.device), at] = toks
        self._valid = kv_valid
        # row-gated sequence bans per distinct config
        for ci, (ngram, bad_words) in enumerate(lp_configs):
            gen = GenerationConfig(no_repeat_ngram_size=ngram,
                                   bad_words_ids=bad_words)
            processed = sampling.process_logits(
                logits, self._buffer, written + 1, gen, st["valid_from"])
            logits = torch.where((st["lp_idx"] == ci)[:, None], processed,
                                 logits)
        nxt = sampling.sample_rows(
            logits, do_sample=st["do_sample"],
            temperature=st["temperature"], top_k=st["top_k"],
            top_p=st["top_p"], generator=self._rng)
        nxt = torch.where(alive, nxt, torch.zeros_like(nxt))
        # the slot state advances on the device: iteration t + 1 is
        # queued from t's outputs with no host readback between
        emitted2 = emitted + alive
        written2 = written + alive
        alive2 = (alive & (nxt != st["eos"]) & (emitted2 < st["max_new"])
                  & (written2 + self._room <= L))
        out = (nxt, alive2, written2, emitted2)
        return out + (logits,) if need_logits else out

    # ── chunked prefill ──────────────────────────────────────────────

    @torch.no_grad()
    def _chunk_begin(self, vision_x, lang_x, gen, out,
                     t_submit: float = 0.0):
        """Reserve a slot and dispatch the vision encode and the first
        chunk; the scheduler advances one chunk per iteration after."""
        free = next(i for i, s in enumerate(self._slots)
                    if not s.active and not s.pending)
        lang_x = np.asarray(lang_x)
        real = int(lang_x.shape[1])
        bucket = _round_bucket(real, self.buckets)
        ids, mask = left_pad(lang_x, None, target_len=bucket,
                             pad_id=gen.pad_token_id)
        ids, mask = _on(ids, self.device).long(), _on(mask, self.device)
        lat = self.model.encode_vision(_on(vision_x, self.device))
        # the xattn media ids of the whole padded prompt, sliced per chunk:
        # an early chunk may come before its media token
        q_ids, kv_ids, keep = media_attention_ids(
            ids == self.cfg.media_token_id, lat.shape[1], lat.shape[2],
            only_attend_immediate_media=self.cfg.only_attend_immediate_media,
            attend_previous=True)
        task = dict(slot=free, gen=gen, out=out, t_submit=t_submit,
                    cache=init_cache(self.cfg.text, 1, bucket,
                                     self.cache_dtype, self.device),
                    lat=lat, ids=ids, mask=mask,
                    positions=(mask.cumsum(-1) - 1).clamp_min(0),
                    xattn=(q_ids, kv_ids, keep), real=real, bucket=bucket,
                    next=0, n=bucket // self.prefill_chunk,
                    media=int(np.sum(lang_x == self.cfg.media_token_id)),
                    last=None, vision_x=vision_x)
        slot = self._slots[free]
        slot.gen = gen
        slot.out = out
        slot.pending = True
        slot.active = False
        slot.t_submit = t_submit
        self._chunk_tasks.append(task)
        self._advance_task(task)
        return task

    @torch.no_grad()
    def _chunk_step(self, task) -> None:
        """Chunk `task["next"]` of a prompt: C tokens appended to the
        request's own cache through the decoder's multi-token cached step
        (block-causal inside the chunk, `kv_valid` over the cache)."""
        C = self.prefill_chunk
        off = task["next"] * C
        sl = slice(off, off + C)
        ids, mask = task["ids"], task["mask"]
        cols = torch.arange(ids.shape[1], device=self.device)[None, :]
        kv_valid = mask.bool() & (cols < off + C)
        q_ids, kv_ids, keep = task["xattn"]
        logits, task["cache"], _ = self.model(
            None, ids[:, sl], vis_latents=task["lat"], cache=task["cache"],
            cache_pos=off, kv_valid=kv_valid,
            positions=task["positions"][:, sl],
            xattn_ids=(q_ids[:, sl], kv_ids, keep[:, sl]),
            head_last_only=True)
        task["last"] = logits[:, -1]

    def _advance_task(self, task):
        self._chunk_step(task)
        task["next"] += 1
        if task["next"] >= task["n"]:
            self._chunk_tasks.remove(task)
            self._ready_chunked.append(task)

    def _advance_chunked(self):
        # one chunk per scheduler iteration, round-robin across the
        # admissions in flight: every stream's stall stays one chunk
        if self._chunk_tasks:
            self._advance_task(self._chunk_tasks[0])
            if self._chunk_tasks:
                self._chunk_tasks.append(self._chunk_tasks.pop(0))

    def _finalize_chunked(self):
        """Pooled-state half of a chunked admission (in-flight iterations
        drained): insert the assembled cache, sample the first token and
        hand it to the finisher, as `_admit_start` does."""
        ready, self._ready_chunked = self._ready_chunked, []
        for task in ready:
            free, gen = task["slot"], task["gen"]
            bucket, real = task["bucket"], task["real"]
            self._insert(free, task["cache"], bucket, task["ids"][0],
                         task["mask"][0], task["lat"])
            if self.model_d is not None:
                # the draft prefills in one shot: it is several times
                # smaller, far below the stall a chunk bounds
                self._admit_draft(task["vision_x"], task["ids"],
                                  task["mask"], bucket, free)
            tok_dev = self._first_token(task["last"], task["ids"], bucket,
                                        real, gen)
            slot = self._slots[free]
            slot.real_len = real
            slot.bucket = bucket
            slot.written = bucket
            slot.emitted = 1
            slot.media = task["media"]
            self._force_q.put((slot, self._to_host(tok_dev)))

    # ── beam groups ──────────────────────────────────────────────────

    def _reorder(self, rows: torch.Tensor, parents: torch.Tensor):
        """Parent-beam rows into the group's rows, in every pooled cache
        tensor, the token buffer and the valid mask (the latents are the
        same across a group)."""
        for x in list(self._cache.values()) + [self._buffer, self._valid]:
            x.index_copy_(0, rows, x.index_select(0, parents))

    # ── the speculative round ────────────────────────────────────────

    @staticmethod
    def _proc_rows(logits, temperature, top_k, top_p):
        """The processed per-row sampling distribution [B, V]: the order of
        `sampling.sample_rows`, so a draw of `sample_rows` is a draw from
        these probabilities."""
        scaled = (logits.float()
                  / temperature.float().clamp_min(1e-6)[:, None])
        return torch.softmax(sampling.filter_rows(scaled, top_k, top_p), -1)

    @torch.no_grad()
    def _spec_round(self, ca: Dict[str, torch.Tensor],
                    st: Dict[str, Any],
                    lp_configs: Tuple[Tuple[int, Any], ...], g: int):
        """One speculative round of every slot: the draft's s=2 opener over
        [buffer[W-1], toks] at W-1 (W = `written`, the column of `toks`, the
        delivered token no model has ingested) and g-1 single steps, the
        target's s=g+1 verify window [toks, d_1..d_g] at W, then each row's
        accepted prefix and the target's correction (greedy rows), or the
        rejection rule (sampled rows), cut at eos and at max_new_tokens.
        Exactly the committed columns join `valid`; the rest of the window
        stays outside it until a later round overwrites it. Returns (out
        [B, g+1], e [B]: a row emits out[:e], and the next round's toks,
        alive, written, emitted), all on the device.

        The opener re-ingests W-1, the same k/v where it is cached: a fully
        accepted round leaves the draft one column short (the target
        verified d_g, the draft never ingested it). A dead row (finished,
        or never admitted) keeps stepping with the pool; its writes go to
        its own columns below the cache's end (JAX drops the writes past
        it), which its next admission rewrites."""
        toks, alive, written, emitted = (ca["toks"], ca["alive"],
                                         ca["written"], ca["emitted"])
        B, L, dev = self.n, self.L, self.device
        rows = torch.arange(B, device=dev)
        cols = torch.arange(L, device=dev)[None, :]
        w = torch.where(alive, written, written.clamp_max(L - self.gamma - 1))

        def win_valid(last_off: int):
            # the committed columns and this round's window [W-1, W+off]
            return self._valid | ((cols >= (w - 1)[:, None])
                                  & (cols <= (w + last_off)[:, None]))

        ctl = dict(do_sample=st["do_sample"], temperature=st["temperature"],
                   top_k=st["top_k"], top_p=st["top_p"])
        sampled = st["sampled"]

        def propose(lg):
            if not sampled:
                return lg.argmax(-1), None
            return (sampling.sample_rows(lg, generator=self._rng, **ctl),
                    self._proc_rows(lg, ctl["temperature"], ctl["top_k"],
                                    ctl["top_p"]))

        self._buffer[rows, w] = toks
        w1 = (w - 1).clamp_min(0)
        pos0 = (st["real_len"] + emitted - 1).clamp_min(1)   # toks' position
        draft = dict(vis_latents=self._latents_d, cache=self._cache_d,
                     media_counts=st["media"])
        lg, _, _ = self.model_d(
            None, torch.stack([self._buffer[rows, w1], toks], 1),
            cache_pos=w1, kv_valid=win_valid(0),
            positions=torch.stack([pos0 - 1, pos0], 1), **draft)
        ds, qs = [], []
        for i in range(g):
            if i:
                lg, _, _ = self.model_d(
                    None, ds[-1][:, None], cache_pos=w + i,
                    kv_valid=win_valid(i), positions=(pos0 + i)[:, None],
                    **draft)
            d, q = propose(lg[:, -1])
            ds.append(d)
            qs.append(q)
        d = torch.stack(ds, 1)                                 # [B, g]
        window = torch.cat([toks[:, None], d], 1)
        idx = torch.arange(g + 1, device=dev)
        lg_t, _, _ = self.model(
            None, window, vis_latents=self._latents, cache=self._cache,
            cache_pos=w, kv_valid=win_valid(g),
            positions=pos0[:, None] + idx[None, :], media_counts=st["media"])
        self._buffer[rows[:, None], w[:, None] + idx[None, :]] = window
        # row-gated sequence bans at every window position
        for ci, (ngram, bad_words) in enumerate(lp_configs):
            genc = GenerationConfig(no_repeat_ngram_size=ngram,
                                    bad_words_ids=bad_words)
            proc = torch.stack([sampling.process_logits(
                lg_t[:, j], self._buffer, written + 1 + j, genc,
                st["valid_from"]) for j in range(g + 1)], 1)
            lg_t = torch.where((st["lp_idx"] == ci)[:, None, None], proc,
                               lg_t)
        # greedy: the agreeing prefix and the target's correction
        t_arg = lg_t.argmax(-1)                                # [B, g+1]
        m = torch.cumprod((t_arg[:, :g] == d).long(), 1).sum(1)
        out = torch.where(idx[None] < m[:, None],
                          torch.cat([d, d[:, -1:]], 1), t_arg)
        if sampled:
            v = lg_t.shape[-1]
            rep = lambda x: x.repeat_interleave(g + 1)
            p = self._proc_rows(lg_t.reshape(B * (g + 1), v),
                                rep(ctl["temperature"]), rep(ctl["top_k"]),
                                rep(ctl["top_p"])).reshape(B, g + 1, v)
            out_s, n_s = accept_resample_rows(p, torch.stack(qs, 1), d,
                                              self._rng)
            out = torch.where(st["do_sample"][:, None], out_s, out)
            m = torch.where(st["do_sample"], n_s - 1, m)
        # cut at eos, then at the row's max_new_tokens
        eos = st["eos"][:, None]
        eos_at = torch.where(out == eos, idx[None], g + 1).amin(1)
        e = torch.minimum(torch.minimum(m + 1, eos_at + 1),
                          st["max_new"] - emitted)
        e = torch.where(alive, e, torch.zeros_like(e))
        self._valid = self._valid | ((cols >= written[:, None])
                                     & (cols < (written + e)[:, None]))
        written2, emitted2 = written + e, emitted + e
        eos_hit = ((out == eos) & (idx[None] < e[:, None])).any(1)
        alive2 = (alive & ~eos_hit & (emitted2 < st["max_new"])
                  & (written2 + self._room <= L))
        toks2 = torch.where(
            e > 0, out.gather(1, (e - 1).clamp_min(0)[:, None])[:, 0], toks)
        return out, e, toks2, alive2, written2, emitted2

    # ── the acceptance-adaptive controller ───────────────────────────

    def _modes_ladder(self) -> List[Any]:
        """The candidate modes: gamma, gamma // 2 (at most two speculative
        tiers) and plain decode."""
        modes: List[Any] = [("spec", self.gamma)]
        if self.gamma >= 2:
            modes.append(("spec", max(1, self.gamma // 2)))
        return modes + ["plain"]

    def _next_mode(self) -> Any:
        if not self.spec_adaptive:
            return ("spec", self.gamma)
        if self._probe_plan:
            return self._probe_plan.pop(0)
        return self._mode_now

    def _note_iter_time(self, mode) -> None:
        """An EMA of the host seconds an iteration in each mode. An
        iteration is queued once the one before it has been read back
        (pipeline depth 1), so the time between two queued iterations of
        one mode follows the device's round; a mode switch or an admission
        starts the timing afresh. No sync of its own."""
        now = self._clock()
        if self._last_mode == mode and self._t_last_iter is not None:
            dt = now - self._t_last_iter
            prev = self._iter_times.get(mode)
            self._iter_times[mode] = dt if prev is None \
                else 0.8 * prev + 0.2 * dt
        self._t_last_iter = now
        self._last_mode = mode

    def _mode_rate(self, mode) -> Optional[float]:
        """The estimated tokens a second a row of a mode (None: not yet
        measured)."""
        t = self._iter_times.get(mode)
        if t is None:
            return None
        if mode == "plain":
            return 1.0 / t
        e = self._accept_ema.get(mode[1])
        return None if e is None else e / t

    def _maybe_replan(self) -> None:
        """Every `_replan_every` drained iterations: probe a mode that has
        no measurement (`_probe_len` iterations; probing changes no
        output), else switch to the fastest measured mode with 5%
        hysteresis. Every `_stale_every` iterations the suspended modes
        are probed again, as acceptance drifts with the traffic."""
        if not self.spec_adaptive or self._probe_plan:
            return
        self._ctrl_count += 1
        self._stale_count += 1
        if self._ctrl_count % self._replan_every:
            return
        modes = self._modes_ladder()
        rates = {m: self._mode_rate(m) for m in modes}
        unknown = [m for m in modes if rates[m] is None]
        if unknown:
            self._probe_plan.extend([unknown[0]] * self._probe_len)
            return
        if self._stale_count >= self._stale_every:
            self._stale_count = 0
            for m in modes:
                if m != self._mode_now:
                    self._probe_plan.extend([m] * self._probe_len)
            return
        best = max(modes, key=lambda m: rates[m])
        if best != self._mode_now \
                and rates[best] > 1.05 * rates[self._mode_now]:
            self._mode_now = best

    @torch.no_grad()
    def _run_catchup(self) -> None:
        """After plain steps the draft's cache misses their columns:
        re-ingest each row's last `_catchup_w` generated columns (from its
        first decode column on: the prompt's columns came with the
        admission) in one draft window. Columns already cached get the
        same k/v; columns at and after `written` get junk that the next
        round overwrites before they are valid. The window stays inside
        the cache: it starts at max(written - W, bucket) and W is at most
        the cache less the largest bucket. Older gaps stay holes, which
        cost acceptance, never output."""
        st, W = self._statics, self._catchup_w
        written = self._carried["written"]
        floor = self._dev([s.bucket for s in self._slots], torch.long)
        start = torch.maximum(written - W, floor)
        cols = start[:, None] + torch.arange(W, device=self.device)[None, :]
        self.model_d(
            None, self._buffer.gather(1, cols.clamp_max(self.L - 1)),
            vis_latents=self._latents_d, cache=self._cache_d,
            cache_pos=start, kv_valid=self._valid,
            positions=(cols - st["valid_from"][:, None]).clamp_min(0),
            media_counts=st["media"])

    def _step_spec(self) -> bool:
        """One iteration of a speculative pool: a round (or, as the
        controller chooses, a plain step or a round of a smaller gamma)
        queued with no host wait, the carried slot state flowing on the
        device, then the oldest in-flight iteration read back."""
        slots = self._slots
        if not any(s.active for s in slots):
            self._drain_all()
            return False
        if self._dirty or self._carried is None:
            self._lp_list, self._statics = self._static_args(slots)
            self._carried = self._carried_args(slots)
            self._dirty = False
            self._t_last_iter = None
        mode = self._next_mode()
        self._note_iter_time(mode)
        if mode == "plain":
            self._draft_stale = True
            res = self._dispatch(need_logits=False)
            self._inflight.append((self._to_host(res[0]),
                                   self._active_rows(), "plain"))
        else:
            if self._draft_stale:
                self._run_catchup()
                self._draft_stale = False
            out, e, toks2, alive2, written2, emitted2 = self._spec_round(
                self._carried, self._statics, self._lp_list, mode[1])
            self._carried = dict(toks=toks2, alive=alive2, written=written2,
                                 emitted=emitted2)
            self._inflight.append((self._to_host(torch.cat(
                [out, e[:, None]], 1)), self._active_rows(), mode))
        while len(self._inflight) > self.pipeline_depth:
            self._drain_one()
        return True

    def _drain_one_spec(self, copy, snapshot, g: int):
        """Read a round's (out, e) and stream each row's emitted prefix;
        the host's slot state follows the device's alive rule (eos,
        max_new_tokens, the gamma+1 columns a round needs)."""
        vals = self._host_values(copy)
        out, e = vals[:, :g + 1], vals[:, g + 1]
        live = [i for i in snapshot if self._slots[i].active]
        if live:
            # the controller's acceptance: the pool's mean tokens a round
            mean_e = float(np.mean([e[i] for i in live]))
            prev = self._accept_ema.get(g)
            self._accept_ema[g] = mean_e if prev is None \
                else 0.8 * prev + 0.2 * mean_e
            for i in live:
                s = self._slots[i]
                s.accept_ema = (float(e[i]) if s.accept_ema is None
                                else 0.8 * s.accept_ema + 0.2 * float(e[i]))
        self._maybe_replan()
        for i in snapshot:
            s = self._slots[i]
            if not s.active:
                continue
            eos, closed = self._eos(s.gen), False
            for tok in out[i, :int(e[i])]:
                tok = int(tok)
                s.written += 1
                s.emitted += 1
                if tok == eos:
                    s.out.put(None)
                    self._finish(s)
                    closed = True
                    break
                s.out.put(tok)
                s.last_tok = tok
            if not closed and (s.emitted >= s.gen.max_new_tokens
                               or s.written + self._room > self.L):
                s.out.put(None)
                self._finish(s)

    # ── scheduler ─────────────────────────────────────────────────────

    def _admit_start(self, vision_x, lang_x, gen, out,
                     t_submit: float = 0.0):
        """Dispatch one admission (prefill, insert, first-token sample)
        without waiting on the device; returns (slot, device token)."""
        if gen.num_beams > 1:
            return self._admit_start_beam(vision_x, lang_x, gen, out,
                                          t_submit)
        free = next(i for i, s in enumerate(self._slots)
                    if not s.active and not s.pending)
        lang_x = np.asarray(lang_x)
        real = int(lang_x.shape[1])
        bucket = _round_bucket(real, self.buckets)
        ids, mask = left_pad(lang_x, None, target_len=bucket,
                             pad_id=gen.pad_token_id)
        ids, mask = _on(ids, self.device).long(), _on(mask, self.device)
        last_logits, small, lat = self._prefill(vision_x, ids, mask, bucket)
        self._insert(free, small, bucket, ids[0], mask[0], lat)
        if self.model_d is not None:
            self._admit_draft(vision_x, ids, mask, bucket, free)
        tok_dev = self._first_token(last_logits, ids, bucket, real, gen)

        slot = self._slots[free]
        slot.gen = gen
        slot.out = out
        slot.real_len = real
        slot.bucket = bucket
        slot.written = bucket
        slot.emitted = 1
        slot.media = int(np.sum(lang_x == self.cfg.media_token_id))
        # pending, not active: the slot joins the decode pool when the
        # finisher lands its first token (`_collect_admitted`); until then
        # decode steps leave the row out (their writes to it are
        # overwritten by its first real step)
        slot.pending = True
        slot.active = False
        slot.t_submit = t_submit
        return slot, tok_dev

    def _admit_start_beam(self, vision_x, lang_x, gen, out,
                          t_submit: float = 0.0):
        """Admit a num_beams=k request into k slots: one prefill, its cache
        copied into each beam row, then a top-k fan-out over the prefill
        logits (`generation/beam.py` `_beam_setup`)."""
        k = gen.num_beams
        free = [i for i, s in enumerate(self._slots)
                if not s.active and not s.pending][:k]
        lang_x = np.asarray(lang_x)
        real = int(lang_x.shape[1])
        bucket = _round_bucket(real, self.buckets)
        ids, mask = left_pad(lang_x, None, target_len=bucket,
                             pad_id=gen.pad_token_id)
        ids, mask = _on(ids, self.device).long(), _on(mask, self.device)
        last_logits, small, lat = self._prefill(vision_x, ids, mask, bucket)
        for row in free:
            self._insert(row, small, bucket, ids[0], mask[0], lat)
        logits0 = last_logits
        if gen.no_repeat_ngram_size or gen.bad_words_ids:
            logits0 = sampling.process_logits(logits0, ids, bucket, gen,
                                              bucket - real)
        logp0 = torch.log_softmax(logits0[0].float(), dim=-1)
        first_scores, first_toks = _top_k(logp0, k)

        gid = self._next_group
        self._next_group += 1
        grp = _BeamGroup(gen=gen, out=out, rows=list(free), gid=gid,
                         t_submit=t_submit)
        self._groups[gid] = grp
        media = int(np.sum(lang_x == self.cfg.media_token_id))
        for row in free:
            s = self._slots[row]
            s.gen = gen
            s.out = None            # delivery goes through the group
            s.real_len = real
            s.bucket = bucket
            s.written = bucket
            s.emitted = 1
            s.media = media
            s.active = True
            s.group = gid
            s.t_submit = t_submit
        return grp, (first_toks, first_scores)

    def _eos(self, gen: GenerationConfig) -> int:
        return (gen.eos_token_id if gen.eos_token_id is not None
                else self.cfg.eoc_token_id)

    def _admit_finish_beam(self, grp: _BeamGroup, dev):
        toks = dev[0].cpu().numpy()
        scores = dev[1].cpu().numpy().astype(np.float32)
        gen = grp.gen
        eos = self._eos(gen)
        neg_inf = np.float32(-1e9)
        live = np.where(toks == eos, neg_inf, scores)
        for t, s in zip(toks, scores):
            if int(t) == eos:
                # a one-token finished hypothesis (empty visible text)
                grp.fin.append((float(s) / (1.0 ** gen.length_penalty),
                                []))
        grp.scores = live
        grp.hyps = [[int(t)] for t in toks]
        now = time.monotonic()
        for i, row in enumerate(grp.rows):
            s = self._slots[row]
            s.last_tok = int(toks[i])
            s.t_admit = s.t_first = now
        if gen.max_new_tokens <= 1 or bool(np.all(live <= neg_inf)):
            self._finalize_group(grp)

    def _admit_finish_slot(self, slot: _Slot, tok: int):
        gen, out = slot.gen, slot.out
        eos = self._eos(gen)
        slot.last_tok = tok
        slot.t_admit = slot.t_first = time.monotonic()
        if tok == eos or gen.max_new_tokens <= 1:
            if tok != eos:
                out.put(tok)
            out.put(None)
            self._finish(slot)
        else:
            out.put(tok)

    def _beam_advance(self, grp: _BeamGroup, logits: torch.Tensor):
        """One beam step of a group: top-2k candidates over its rows'
        processed logits, the finished / live bookkeeping on the host, and
        the reorder of the group's rows to the chosen parents (HF
        semantics, as `generation/beam.py`)."""
        k = len(grp.rows)
        gen = grp.gen
        rows = torch.tensor(grp.rows, device=self.device)
        lp = torch.log_softmax(logits[rows].float(), dim=-1)     # [k, V]
        vocab = lp.shape[-1]
        total = torch.from_numpy(grp.scores).to(self.device)[:, None] + lp
        top, idx = _top_k(total.reshape(-1), 2 * k)
        top, idx = top.cpu().numpy(), idx.cpu().numpy()
        beams, toks = idx // vocab, idx % vocab
        eos = self._eos(gen)
        cur_len = len(grp.hyps[0]) + 1

        def pen(score, length):
            return float(score) / (float(length) ** gen.length_penalty)

        live: List[Tuple[float, int, int]] = []
        for s, b, t in zip(top, beams, toks):
            if int(t) == eos:
                # a hypothesis delivered without its eos (the stream's
                # contract)
                grp.fin.append((pen(s, cur_len), list(grp.hyps[int(b)])))
            elif len(live) < k:
                live.append((float(s), int(b), int(t)))
        grp.fin = sorted(grp.fin, key=lambda x: x[0], reverse=True)[:k]

        parents = [grp.rows[b] for _, b, _ in live]
        if parents != grp.rows:
            self._reorder(rows, torch.tensor(parents, device=self.device))
        grp.hyps = [grp.hyps[b] + [t] for _, b, t in live]
        grp.scores = np.asarray([s for s, _, _ in live], np.float32)
        emitted = 0
        for i, row in enumerate(grp.rows):
            s = self._slots[row]
            s.written += 1
            s.emitted += 1
            s.last_tok = live[i][2]
            emitted = s.emitted
        max_len_hit = (emitted >= gen.max_new_tokens
                       or self._slots[grp.rows[0]].written >= self.L)
        if max_len_hit or (gen.early_stopping and len(grp.fin) >= k):
            self._finalize_group(grp)

    def _finalize_group(self, grp: _BeamGroup):
        """Deliver the best hypothesis (finished pool against the
        length-penalized live beams) and free the group's slots."""
        gen = grp.gen
        cands = list(grp.fin)
        for score, hyp in zip(grp.scores, grp.hyps):
            if score > -1e8:
                cands.append(
                    (float(score) / (float(len(hyp))
                                     ** gen.length_penalty), list(hyp)))
        best = max(cands, key=lambda x: x[0])[1] if cands else []
        for tok in best:
            grp.out.put(int(tok))
        grp.out.put(None)
        for i, row in enumerate(grp.rows):
            s = self._slots[row]
            if i == 0:
                self._finish(s)      # one latency record per request
            else:
                s.active = False
            s.group = None
        self._groups.pop(grp.gid, None)

    def _finish(self, slot: _Slot):
        """Close a request and record its latency."""
        slot.active = False
        now = time.monotonic()
        decode_s = max(now - slot.t_first, 1e-9)
        with self._lock:
            self._completed.append({
                "prompt_tokens": slot.real_len,
                "new_tokens": slot.emitted,
                "ttft_s": (slot.t_first - slot.t_submit
                           if slot.t_submit else 0.0),
                "queue_s": (slot.t_admit - slot.t_submit
                            if slot.t_submit else 0.0),
                "decode_tok_s": (slot.emitted - 1) / decode_s,
                "total_s": now - (slot.t_submit or slot.t_first),
            })
            if len(self._completed) > 1024:
                del self._completed[: len(self._completed) - 1024]

    def _admit(self) -> int:
        """Start what the queue and the free slots allow; returns how many
        admissions began."""
        decoding = any(s.active for s in self._slots)
        started = []
        n_started = 0

        def free_count():
            return sum(not s.active and not s.pending
                       for s in self._slots)

        def try_start(item) -> bool:
            nonlocal n_started
            gen = item[2]
            if max(1, gen.num_beams) > free_count():
                return False
            C = self.prefill_chunk
            if C and gen.num_beams <= 1:
                bucket = _round_bucket(int(np.asarray(item[1]).shape[1]),
                                       self.buckets)
                if bucket > C and bucket % C == 0:
                    self._chunk_begin(*item)
                    n_started += 1
                    return True
            started.append(self._admit_start(*item))
            n_started += 1
            return True

        # beam requests blocked on free slots go first; smaller requests
        # may fill in around a blocked one
        still = []
        for item in self._deferred:
            if (decoding and n_started >= self.max_admits_per_iter) \
                    or not try_start(item):
                still.append(item)
        self._deferred = still
        while not self._pending.empty():
            if decoding and n_started >= self.max_admits_per_iter:
                break
            if free_count() == 0:
                break
            try:
                item = self._pending.get_nowait()
            except queue.Empty:
                break
            if not try_start(item):
                self._deferred.append(item)
        # every prefill is queued; single-stream first tokens reach the
        # host on the finisher thread, in dispatch order. Beam groups read
        # theirs here: their host-side beam state must exist before the
        # next step treats the group as synchronous
        for slot, tok_dev in started:
            if isinstance(slot, _BeamGroup):
                self._admit_finish_beam(slot, tok_dev)
            else:
                self._force_q.put((slot, self._to_host(tok_dev)))
        return n_started

    def _static_args(self, slots):
        """Per-admission host-built tensors and the distinct lp configs:
        constant between admissions, rebuilt when `_dirty`."""
        def arr(fn, dtype):
            return self._dev([fn(s) for s in slots], dtype)

        lp_list: List[Tuple[int, Any]] = []
        lp_idx = []
        for s in slots:
            if s.active and s.gen and (s.gen.no_repeat_ngram_size
                                       or s.gen.bad_words_ids):
                c = (s.gen.no_repeat_ngram_size, s.gen.bad_words_ids)
                if c not in lp_list:
                    lp_list.append(c)
                lp_idx.append(lp_list.index(c))
            else:
                lp_idx.append(-1)
        return tuple(lp_list), dict(
            # a host flag: whether a round needs its sampled half
            sampled=any(s.active and s.gen.do_sample for s in slots),
            real_len=arr(lambda s: s.real_len, torch.long),
            media=arr(lambda s: s.media, torch.int32),
            lp_idx=self._dev(lp_idx, torch.long),
            valid_from=arr(lambda s: s.bucket - s.real_len, torch.long),
            do_sample=arr(lambda s: bool(s.gen.do_sample)
                          if s.gen else False, torch.bool),
            temperature=arr(lambda s: s.gen.temperature if s.gen
                            and s.gen.do_sample and s.gen.temperature > 0
                            else 1.0, torch.float32),
            top_k=arr(lambda s: s.gen.top_k if s.gen else 0, torch.long),
            top_p=arr(lambda s: s.gen.top_p if s.gen else 1.0,
                      torch.float32),
            eos=arr(lambda s: self._eos(s.gen) if s.gen
                    else self.cfg.eoc_token_id, torch.long),
            max_new=arr(lambda s: s.gen.max_new_tokens if s.gen else 0,
                        torch.long))

    def _carried_args(self, slots):
        return dict(
            toks=self._dev([s.last_tok for s in slots], torch.long),
            alive=self._dev([s.active for s in slots], torch.bool),
            written=self._dev([s.written for s in slots], torch.long),
            emitted=self._dev([s.emitted for s in slots], torch.long))

    def _dispatch(self, need_logits: bool):
        """Queue one decode iteration without waiting on the device; the
        carried slot state goes from this iteration's outputs to the
        next's inputs on the device."""
        slots = self._slots
        if self._dirty or self._carried is None:
            self._lp_list, self._statics = self._static_args(slots)
            self._carried = self._carried_args(slots)
            self._dirty = False
        res = self._decode_step(self._carried, self._statics,
                                self._lp_list, need_logits)
        nxt, alive2, written2, emitted2 = res[:4]
        self._carried = dict(toks=nxt, alive=alive2, written=written2,
                             emitted=emitted2)
        return res

    def _drain_one(self):
        """Read the oldest in-flight iteration's tokens and stream them
        (the host's written / emitted / active advance as the device's
        did in `_decode_step`). An entry is (copy, rows, kind): kind
        "plain" for a decode step, ("spec", gamma) for a round."""
        copy, snapshot, kind = self._inflight.pop(0)
        if kind != "plain":
            return self._drain_one_spec(copy, snapshot, kind[1])
        if self.model_d is not None:
            self._maybe_replan()   # the controller counts plain steps too
        toks = self._host_values(copy)
        for i in snapshot:
            s = self._slots[i]
            if not s.active or s.group is not None:
                continue
            tok = int(toks[i])
            s.written += 1
            s.emitted += 1
            if tok == self._eos(s.gen):
                s.out.put(None)
                self._finish(s)
            elif s.emitted >= s.gen.max_new_tokens \
                    or s.written + self._room > self.L:
                s.out.put(tok)
                s.out.put(None)
                self._finish(s)
            else:
                s.out.put(tok)
                s.last_tok = tok

    def _drain_all(self):
        while self._inflight:
            self._drain_one()

    def _active_rows(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s.active]

    def _step(self):
        if self.model_d is not None:
            # speculative rounds, pipelined as plain steps are (a draft
            # pool holds no beam group: submit runs beams greedy)
            return self._step_spec()
        if self._groups:
            # a beam group reads its candidates every iteration: no
            # pipelining while one is in the pool
            self._drain_all()
            return self._step_sync()
        if not any(s.active for s in self._slots):
            self._drain_all()
            return False
        res = self._dispatch(need_logits=False)
        self._inflight.append((self._to_host(res[0]), self._active_rows(),
                               "plain"))
        while len(self._inflight) > self.pipeline_depth:
            self._drain_one()
        return True

    def _step_sync(self):
        slots = self._slots
        if not any(s.active for s in slots):
            return False
        res = self._dispatch(need_logits=True)
        for grp in list(self._groups.values()):
            self._beam_advance(grp, res[4])
        self._inflight.append((self._to_host(res[0]), self._active_rows(),
                               "plain"))
        self._drain_all()
        # the beam bookkeeping rewrote host slot state: rebuild carried
        self._dirty = True
        return any(s.active for s in slots)

    def _loop(self):
        # a scheduler failure fails every stream: consumers never block on
        # a dead scheduler's queues, and later submits raise
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._loop_inner()
        except Exception as e:   # noqa: BLE001 - delivered to every stream
            self._fail_streams(e)

    def _fail_streams(self, exc: BaseException):
        """Record the failure and fail every stream: in the slots, in the
        beam groups, mid chunked prefill, deferred and queued. The failure
        is set and the queue drained under the lock that `submit` holds
        from its check to its put, so no request is left unfailed."""
        sent = _SchedulerError(exc)
        with self._lock:
            self._failure = exc
            outs = [s.out for s in self._slots if s.out is not None]
            outs += [g.out for g in self._groups.values()]
            outs += [t["out"] for t in self._chunk_tasks
                     + self._ready_chunked]
            outs += [d[3] for d in self._deferred]
            while True:
                try:
                    outs.append(self._pending.get_nowait()[3])
                except queue.Empty:
                    break
        for out in outs:
            out.put(sent)

    def _loop_inner(self):
        while not self._stop and self._failure is None:
            if (not self._pending.empty() or self._deferred
                    or self._finished or self._ready_chunked):
                # admissions change pooled state and reuse freed slots:
                # drain in-flight iterations first, then activate finished
                # admissions and insert new ones. The carried state is
                # rebuilt only where one of them changed a slot: a request
                # that waits for a slot leaves it (and the controller's
                # iteration timing) as it was
                self._drain_all()
                self._collect_admitted()
                if self._ready_chunked:
                    self._finalize_chunked()
                    self._dirty = True
                if self._admit():
                    self._dirty = True
            busy = self._step()
            # one prefill chunk rides after each decode iteration
            self._advance_chunked()
            if (not busy and self._pending.empty() and not self._deferred
                    and not self._finished and not self._chunk_tasks
                    and not self._ready_chunked):
                # the finisher sets _work when a first token lands (the
                # timeout covers a lost wakeup)
                self._drain_all()
                self._work.clear()
                self._work.wait(timeout=0.2)
