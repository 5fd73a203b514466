"""Model worker (counterpart of `otter_tpu/serve/worker.py`): the port's
generation engines behind the streaming HTTP protocol of the reference
worker (`pipeline/serve/model_worker.py`):

  - registers with the controller and heartbeats every WORKER_HEART_BEAT
    seconds (model_worker.py:44-52,120-155)
  - /worker_generate_stream: base64 images -> vision_x (B,T,F,C,H,W)
    (:181-206; a list-of-lists means one video, frames along F) ->
    streaming decode -> `\\0`-delimited JSON {"text": cumulative,
    "error_code": 0} chunks (:251-263)
  - /worker_get_status (:164-168)

The otter family decodes through `OtterGenerator.stream_generate` (and
`stream_beam_generate` for `num_beams > 1`), the idefics family through
`OtterGenerator.stream_generate` over an `IdeficsVLM`, the fuyu family
through `generation.fuyu.fuyu_generate`. Each request's generator runs on the
aiohttp app's executor threads; requests on one model take turns a decode
step at a time (`_one_step_at_a_time`), and the kernels' first use and
launch counters are thread-safe (`_build.py`). Sampled requests draw from
a `torch.Generator` seeded 0 for every request, as the JAX worker's engine
uses one key.

    python -m otter_tpu_torch.serve.worker --checkpoint DIR \\
        --tokenizer DIR --load-bit int8 --cache-bit int8

runs on the GPU (`--device cpu` for the CPU). `--model-family idefics`
serves an HF `IdeficsForVisionText2Text` checkpoint (idefics-9b, or a
config JSON); its int8 and int4 loads quantize the decoder layers only
(`models.idefics.quantize_decoder`), where the JAX worker's default
patterns also take the head, which its model then cannot find.

`--continuous-batching` (otter and idefics families) serves every request
through one `generation.batching.ContinuousBatcher` instead: concurrent
requests decode in one shared step over `--num-slots` slots of a
`--cache-len` cache, long prompts prefill `--prefill-chunk` tokens at a
time (otter family), and `/worker_get_status` reports the batcher's
`stats()` under "batching". The fuyu family refuses
`--continuous-batching`, which the JAX worker ignores there.

The otter family also takes, as the JAX worker does:

  - `--draft-checkpoint` (with `--draft-config`, a preset, default mpt1b,
    or a config JSON, and `--draft-gamma`): a small draft of the target's
    vocabulary, loaded at the same `--load-bit`. Greedy and sampled
    requests without bans or masked frames decode speculatively
    (`generation.speculative.SpeculativeGenerator`); under
    `--continuous-batching` every pooled iteration is a speculative round,
    with the adaptive controller unless `--no-spec-adaptive`.
  - `--session-cache N`: up to N conversations keep their KV cache between
    turns (`generation.session.SessionPool`); a request with a
    `session_id` prefills only what its session does not hold. With a
    draft the two compose (`SpecChatSession`). A session serves one
    stream at a time: a second request with the same id while the first
    streams takes the stateless path, as one whose conversation outgrew
    `--cache-len` does. Refused with `--continuous-batching` (the slots
    share one cache), as the JAX worker refuses it.

The idefics and fuyu families ignore both, as the JAX worker does.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import threading
import time
import uuid
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from otter_tpu_torch.config import GenerationConfig

WORKER_HEART_BEAT_INTERVAL = 15
SERVER_ERROR_MSG = ("**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE "
                    "OR REFRESH THIS PAGE.**")
SAMPLING_SEED = 0


def decode_media_to_vision_x(images, patch_size: int = 224,
                             mean=None, std=None):
    """Mixed media -> (vision_x [1, T, F, C, H, W], frame_mask [1, T, F]).

    Each list element is a base64 still OR a list of base64 frames (one
    video). Stills stack along T with F=1; videos contribute all their
    frames along F. Mixing works: shorter items are zero-padded along F
    and masked out of the perceiver attention. Strictly more capable than
    the reference worker, which keeps only the LAST video
    (model_worker.py:184-186 `images = images[-1]`)."""
    from otter_tpu_torch.data.mimicit import preprocess_image
    from otter_tpu_torch.data import templates
    from PIL import Image
    if not images:
        return None, None
    mean = mean or templates.FLAMINGO_MEAN
    std = std or templates.FLAMINGO_STD

    def dec(b64):
        img = Image.open(io.BytesIO(
            base64.urlsafe_b64decode(b64))).convert("RGB")
        return preprocess_image(img, patch_size, mean, std)

    items = [[dec(f) for f in (el if isinstance(el, list) else [el])]
             for el in images]
    t = len(items)
    f = max(len(it) for it in items)
    vx = np.zeros((1, t, f) + items[0][0].shape, np.float32)
    mask = np.zeros((1, t, f), bool)
    for i, frames in enumerate(items):
        vx[0, i, : len(frames)] = np.stack(frames, 0)
        mask[0, i, : len(frames)] = True
    return vx, mask


def decode_images_to_vision_x(images, patch_size: int = 224,
                              mean=None, std=None) -> Optional[np.ndarray]:
    """Back-compat wrapper returning only vision_x."""
    vx, _ = decode_media_to_vision_x(images, patch_size, mean, std)
    return vx


class ModelWorker:
    def __init__(self, *, controller_addr: str, worker_addr: str,
                 model_name: str,
                 stream_fn: Callable[[dict], Iterator[str]],
                 limit_model_concurrency: int = 5,
                 no_register: bool = False):
        """stream_fn(params) yields cumulative generated text."""
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.worker_id = str(uuid.uuid4())[:6]
        self.model_name = model_name
        self.stream_fn = stream_fn
        self.limit = limit_model_concurrency
        self._active = 0
        self._lock = threading.Lock()
        if not no_register:
            self.register_to_controller()
            self.heart_beat_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True)
            self.heart_beat_thread.start()

    # ── controller interaction ──────────────────────────────────────

    def register_to_controller(self):
        import requests
        requests.post(self.controller_addr + "/register_worker", json={
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.get_status(),
        }, timeout=10)

    def _heartbeat_loop(self):
        import requests
        while True:
            time.sleep(WORKER_HEART_BEAT_INTERVAL)
            try:
                r = requests.post(
                    self.controller_addr + "/receive_heart_beat",
                    json={"worker_name": self.worker_addr,
                          "queue_length": self.get_queue_length()},
                    timeout=5)
                if not r.json().get("exist"):
                    self.register_to_controller()  # controller restarted
            except Exception:
                pass

    def get_queue_length(self) -> int:
        return max(self._active - self.limit, 0) + self._active

    def get_status(self) -> dict:
        status = {"model_names": [self.model_name], "speed": 1,
                  "queue_length": self.get_queue_length()}
        stats = getattr(self.stream_fn, "stats", None)
        if stats is not None:
            # a continuous-batching worker reports its latency aggregates
            # (TTFT / decode-rate percentiles, queue depth)
            status["batching"] = stats()
        return status

    # ── generation ──────────────────────────────────────────────────

    def generate_stream_gate(self, params: dict) -> Iterator[bytes]:
        with self._lock:
            self._active += 1
        try:
            for text in self.stream_fn(params):
                yield json.dumps(
                    {"text": text, "error_code": 0}).encode() + b"\0"
        except ValueError as e:
            yield json.dumps(
                {"text": f"{SERVER_ERROR_MSG} ({e})",
                 "error_code": 1}).encode() + b"\0"
        except Exception as e:
            yield json.dumps(
                {"text": f"{SERVER_ERROR_MSG} ({type(e).__name__})",
                 "error_code": 1}).encode() + b"\0"
        finally:
            with self._lock:
                self._active -= 1


def _parse_gen_kwargs(gk: dict) -> GenerationConfig:
    return GenerationConfig(
        max_new_tokens=int(gk.get("max_new_tokens", 512)),
        do_sample=bool(gk.get("do_sample", False)),
        temperature=float(gk.get("temperature", 1.0)),
        top_k=int(gk.get("top_k", 0)),
        top_p=float(gk.get("top_p", 1.0)),
        num_beams=int(gk.get("num_beams", 1)),
        length_penalty=float(gk.get("length_penalty", 1.0)),
        no_repeat_ngram_size=int(gk.get("no_repeat_ngram_size", 0)),
        bad_words_ids=(tuple(tuple(int(t) for t in seq)
                             for seq in gk["bad_words_ids"])
                       if gk.get("bad_words_ids") else None),
    )


def _generator(gen: GenerationConfig, device) -> Optional[torch.Generator]:
    """A sampled request's random stream: seeded alike for every request
    (None for greedy requests)."""
    if not gen.do_sample:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(SAMPLING_SEED)
    return g


def _one_step_at_a_time(lock: threading.Lock, steps: Iterator):
    """`steps` (an engine's token generator: its first item runs the
    prefill, each later one a decode step) advanced under `lock`, so
    requests on one model take turns a step at a time. Decoding several
    requests at once without it is slower in aggregate than one after
    another: each step makes ~1500 launches, each of which may give up
    the interpreter lock, and threads queue for it at every one."""
    while True:
        with lock:
            try:
                item = next(steps)
            except StopIteration:
                return
        yield item


def _relay(tokenizer, token_iter, stream_interval: int) -> Iterator[str]:
    """tokens -> cumulative text chunks every `stream_interval`."""
    text, pending = "", []
    for i, tok in enumerate(token_iter):
        pending.append(tok)
        if (i + 1) % stream_interval == 0:
            text += tokenizer.decode(pending, skip_special_tokens=True)
            pending = []
            yield text
    if pending:
        text += tokenizer.decode(pending, skip_special_tokens=True)
    yield text


def make_batched_stream_fn(batcher, tokenizer, cfg, *,
                           stream_interval: int = 2, mean=None, std=None):
    """Bridges the HTTP params to `batcher`, a `ContinuousBatcher`:
    concurrent requests decode in one shared step. mean/std select the
    family's normalization (FLAMINGO by default; IDEFICS for idefics). A
    request without images runs on one zero image. `stream_fn.stats` is
    the batcher's `stats`, which `/worker_get_status` reports."""
    patch_size = cfg.vision.image_size

    def stream_fn(params: dict) -> Iterator[str]:
        vision_x = decode_images_to_vision_x(params.get("images"),
                                             patch_size=patch_size,
                                             mean=mean, std=std)
        if vision_x is None:
            vision_x = np.zeros((1, 1, 1, 3, patch_size, patch_size),
                                np.float32)
        gen = _parse_gen_kwargs(params.get("generation_kwargs", {}))
        enc = tokenizer(params["prompt"], return_tensors="np")
        lang_x = np.asarray(enc["input_ids"]).astype(np.int64)
        yield from _relay(tokenizer, batcher.submit(vision_x, lang_x, gen),
                          stream_interval)

    stream_fn.stats = batcher.stats
    return stream_fn


def make_otter_stream_fn(engine, tokenizer, cfg, *,
                         stream_interval: int = 2, sessions=None, spec=None,
                         spec_sessions=None):
    """Bridges the HTTP params to `engine`, an `OtterGenerator`: greedy and
    sampled requests through `stream_generate` (with the frame mask of
    mixed still+video media), beams through `stream_beam_generate` (the
    best beam so far per chunk, re-rendered whole: a later chunk may
    revise earlier tokens). A request without images runs on one zero
    image, as the JAX worker's does (CLIP, the perceiver and every xattn
    block still run). Concurrent requests decode in turns, a step each
    (`_one_step_at_a_time`).

    The JAX worker's routes, in its order: with `spec_sessions` (a
    `SessionPool` of `SpecChatSession`s) a request with a `session_id`
    that speculation takes (no beams, bans or masked frames) streams from
    its speculative session; with `sessions` (a `SessionPool` of
    `ChatSession`s) one without beams or masked frames from its session;
    with `spec` (a `SpeculativeGenerator`) one that speculation takes
    through `spec.stream`; the rest through the engine. A conversation
    that outgrew its session's cache drops the session and goes on down
    the routes; a session that another stream holds sends the request to
    the stateless routes."""
    patch_size = cfg.vision.image_size
    lock = threading.Lock()

    def steps(token_iter):
        return _relay(tokenizer, _one_step_at_a_time(lock, token_iter),
                      stream_interval)

    def stream_fn(params: dict) -> Iterator[str]:
        prompt = params["prompt"]
        vision_x, frame_mask = decode_media_to_vision_x(
            params.get("images"), patch_size=patch_size)
        if vision_x is None:
            vision_x = np.zeros((1, 1, 1, 3, patch_size, patch_size),
                                np.float32)
            frame_mask = None
        if frame_mask is not None and bool(frame_mask.all()):
            frame_mask = None   # no padding -> skip the masked variant
        gen = _parse_gen_kwargs(params.get("generation_kwargs", {}))
        enc = tokenizer(prompt, return_tensors="np")
        lang_x = np.asarray(enc["input_ids"]).astype(np.int64)
        sid = params.get("session_id")
        spec_ok = (gen.num_beams <= 1 and not gen.no_repeat_ngram_size
                   and not gen.bad_words_ids and frame_mask is None)
        pools = []
        if spec_sessions is not None and sid and spec_ok:
            pools.append(spec_sessions)
        if sessions is not None and sid and gen.num_beams <= 1 \
                and frame_mask is None:
            pools.append(sessions)
        for pool in pools:
            sess = pool.acquire(sid)
            if sess is None:     # another stream holds it: stateless
                break
            try:
                yield from steps(sess.stream(
                    vision_x, lang_x, gen=gen,
                    generator=_generator(gen, engine.device)))
                return
            except ValueError:
                # the conversation outgrew the session's cache
                pool.drop(sid)
            finally:
                pool.release(sess)
        if spec is not None and spec_ok:
            yield from steps(spec.stream(
                vision_x, lang_x, gen=gen,
                generator=_generator(gen, engine.device)))
            return
        if gen.num_beams > 1:
            for toks in _one_step_at_a_time(lock, engine.stream_beam_generate(
                    vision_x, lang_x, gen=gen)):
                yield tokenizer.decode(toks, skip_special_tokens=True)
            return
        yield from steps(engine.stream_generate(
            vision_x, lang_x, gen=gen, vision_mask=frame_mask,
            generator=_generator(gen, engine.device)))

    return stream_fn


def make_idefics_stream_fn(engine, tokenizer, cfg, *,
                           stream_interval: int = 2):
    """Streaming bridge for the IDEFICS family: stills are normalized with
    the IDEFICS mean/std and stacked along N ([1, N, C, H, W]; a request
    without images runs on one zero image), the prompt follows the
    idefics-instruct chat contract (`serve/conversation.py`
    `idefics_instruct`); greedy and sampled requests through
    `engine.stream_generate`, which stops at eos. Concurrent requests
    decode in turns, a step each."""
    from otter_tpu_torch.data.templates import (IDEFICS_STANDARD_MEAN,
                                                IDEFICS_STANDARD_STD)
    patch_size = cfg.vision.image_size
    lock = threading.Lock()

    def stream_fn(params: dict) -> Iterator[str]:
        vision_x, _ = decode_media_to_vision_x(
            params.get("images"), patch_size=patch_size,
            mean=IDEFICS_STANDARD_MEAN, std=IDEFICS_STANDARD_STD)
        if vision_x is None:
            vision_x = np.zeros((1, 1, 1, 3, patch_size, patch_size),
                                np.float32)
        # [1, T, F, C, H, W] -> [1, N, C, H, W] (idefics has no frame axis)
        vision_x = vision_x.reshape((1, -1) + vision_x.shape[3:])
        gen = _parse_gen_kwargs(params.get("generation_kwargs", {}))
        enc = tokenizer(params["prompt"], return_tensors="np")
        lang_x = np.asarray(enc["input_ids"]).astype(np.int64)
        yield from _relay(tokenizer, _one_step_at_a_time(
            lock, engine.stream_generate(
                vision_x, lang_x, gen=gen,
                generator=_generator(gen, engine.device))), stream_interval)

    return stream_fn


def make_fuyu_stream_fn(model, processor, cfg, tokenizer, *,
                        stream_interval: int = 2, resolution=None,
                        cache_dtype=None):
    """Streaming bridge for Fuyu/OtterHD (the reference's Flask deploy
    endpoint, `pipeline/serve/deploy/otterhd_endpoint.py:62-98`, rebuilt on
    the worker protocol): variable-resolution patching through the
    bucketed FuyuProcessor, `fuyu_generate`'s prefill and cached steps,
    box/point coordinate post-processing on the final text. Generation
    stops at the tokenizer's eos; concurrent requests decode in turns, a
    step each."""
    from otter_tpu_torch.generation.fuyu import fuyu_generate
    lock = threading.Lock()

    def stream_fn(http_params: dict) -> Iterator[str]:
        prompt = http_params["prompt"]
        gen = _parse_gen_kwargs(http_params.get("generation_kwargs", {}))
        gen = dataclasses.replace(gen, eos_token_id=tokenizer.eos_token_id)
        imgs = http_params.get("images") or []
        image = None
        if imgs:
            from PIL import Image
            b64 = imgs[0][0] if isinstance(imgs[0], list) else imgs[0]
            image = Image.open(io.BytesIO(
                base64.urlsafe_b64decode(b64))).convert("RGB")
        batch = processor([prompt], [image] if image is not None else None,
                          target_resolution=resolution, left_pad=True)
        out_ids: list = []
        for tok in _one_step_at_a_time(lock, fuyu_generate(
                model, batch["input_ids"], batch["image_patches"],
                batch["image_patches_indices"], batch["attention_mask"],
                gen, cache_dtype=cache_dtype,
                generator=_generator(gen, model.device))):
            out_ids.append(tok)
            if len(out_ids) % stream_interval == 0:
                yield tokenizer.decode(out_ids, skip_special_tokens=True)
        text = tokenizer.decode(out_ids, skip_special_tokens=True)
        # bbox/point token spans -> scaled coordinates
        yield processor.post_process_box_coordinates(text)

    return stream_fn


def build_app(worker: ModelWorker):
    from aiohttp import web

    async def worker_generate_stream(request):
        params = await request.json()
        resp = web.StreamResponse()
        await resp.prepare(request)
        loop = __import__("asyncio").get_event_loop()
        gen = worker.generate_stream_gate(params)

        def next_chunk():
            try:
                return next(gen)
            except StopIteration:
                return None

        while True:
            chunk = await loop.run_in_executor(None, next_chunk)
            if chunk is None:
                break
            await resp.write(chunk)
        return resp

    async def worker_get_status(request):
        return web.json_response(worker.get_status())

    app = web.Application()
    app.router.add_post("/worker_generate_stream", worker_generate_stream)
    app.router.add_post("/worker_get_status", worker_get_status)
    return app


def run_app_in_thread(app, host: str, port: int) -> Callable[[], None]:
    """Serve an aiohttp `app` on `host:port` from a daemon thread with its
    own event loop; returns once the site listens, with a function that
    stops it (so a process can host the worker, or a controller beside
    it, while it does other work)."""
    import asyncio
    from aiohttp import web
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app)
    started = threading.Event()
    failure = []

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(runner.setup())
            loop.run_until_complete(web.TCPSite(runner, host, port).start())
        except OSError as e:
            failure.append(e)
            started.set()
            return
        started.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())
        loop.close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    if not started.wait(60):
        raise RuntimeError(f"the app on {host}:{port} did not start")
    if failure:
        raise failure[0]

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)

    return stop


# ── start-up: checkpoint -> model ─────────────────────────────────────

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32,
           "int8": torch.bfloat16, "int4": torch.bfloat16}
CACHE_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8, "int4": "int4"}


def load_otter_model(checkpoint: str, cfg, *, load_bit: str = "bf16",
                     device=None):
    """The worker's otter-family start-up: an `OtterVLM` of `cfg` with
    `--load-bit` weights (int8 / int4: `quant` set, the decoder and xattn
    kernels quantized as they load), every tensor zero, then the HF
    checkpoint loaded over it (`models.convert.load_otter_checkpoint`: one
    tensor at a time, quantized on the device). Returns (model, cfg)."""
    from otter_tpu_torch.models.convert import load_otter_checkpoint
    from otter_tpu_torch.models.otter import OtterVLM
    cfg = cfg.replace(text=cfg.text.replace(decode_kernel="auto"))
    if load_bit in ("int8", "int4"):
        cfg = cfg.replace(text=cfg.text.replace(quant=load_bit))
    model = OtterVLM(cfg, dtype=_DTYPES[load_bit], device=device)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            t.zero_()
    load_otter_checkpoint(checkpoint, cfg, model)
    return model.eval(), cfg


def load_fuyu_model(checkpoint: str, cfg, *, load_bit: str = "bf16",
                    quant_embed: bool = False, device=None):
    """The worker's fuyu-family start-up: a `FuyuVLM` of `cfg` loaded whole
    from an adept/fuyu-8b-style checkpoint, each tensor converted and
    quantized on the device (persimmon's biased MLPs have no int4 path:
    int4 loads them as int8, as the JAX worker's `quantize_params_int4`
    does). Returns (model, cfg)."""
    from otter_tpu_torch.models.convert import (fuyu_hf_to_port,
                                                load_flax_params,
                                                load_state_dict)
    from otter_tpu_torch.models.fuyu import FuyuVLM
    from otter_tpu_torch.ops.quant import quantize_for
    text = cfg.text.replace(decode_kernel="auto")
    if load_bit in ("int8", "int4"):
        text = text.replace(quant=load_bit)
    if quant_embed:
        text = text.replace(quant_embed=True)
    cfg = cfg.replace(text=text)
    model = FuyuVLM(cfg, dtype=_DTYPES[load_bit], device=device)
    flat = fuyu_hf_to_port(load_state_dict(checkpoint), dtype=model.dtype,
                           device=model.device,
                           num_heads=cfg.text.num_attention_heads)
    load_flax_params(model, quantize_for(cfg.text, flat))
    return model.eval(), cfg


def load_idefics_model(checkpoint: str, cfg, *, load_bit: str = "bf16",
                       device=None):
    """The worker's idefics-family start-up: an `IdeficsVLM` of `cfg`
    loaded whole from an HF `IdeficsForVisionText2Text` checkpoint, each
    tensor converted on the device (`models.convert.idefics_hf_to_port`),
    the decoder layers quantized to int8 under `--load-bit int8` or
    `int4` (`models.idefics.quantize_decoder`: the gated MLPs never pack,
    and the head stays in bf16). Returns (model, cfg)."""
    from otter_tpu_torch.models.convert import (idefics_hf_to_port,
                                                load_flax_params,
                                                load_state_dict)
    from otter_tpu_torch.models.idefics import IdeficsVLM, quantize_decoder
    text = cfg.text.replace(decode_kernel="auto")
    if load_bit in ("int8", "int4"):
        text = text.replace(quant=load_bit)
    cfg = cfg.replace(text=text)
    model = IdeficsVLM(cfg, dtype=_DTYPES[load_bit], device=device)
    flat = idefics_hf_to_port(load_state_dict(checkpoint), cfg,
                              dtype=model.dtype, device=model.device)
    load_flax_params(model, quantize_decoder(cfg, flat))
    return model.eval(), cfg


def _load_config(spec: str, family: str):
    """`--config`: a preset name (otter family), or a config JSON
    (`config.save_config`, or the family config's `to_json`). The fuyu
    family defaults to adept/fuyu-8b's config, the idefics family to
    idefics-9b's."""
    from otter_tpu_torch import config as cfgmod
    classes = {"otter": cfgmod.OtterConfig, "fuyu": cfgmod.FuyuConfig,
               "idefics": cfgmod.IdeficsModelConfig}
    if spec.endswith(".json"):
        with open(spec) as f:
            return classes[family].from_dict(json.load(f))
    if family == "idefics":
        return cfgmod.idefics9b()
    return cfgmod.FuyuConfig() if family == "fuyu" else cfgmod.PRESETS[spec]()


def _run_fuyu_worker(args, device, stream_worker):
    """Host a Fuyu/OtterHD checkpoint behind the worker protocol (the
    reference's standalone OtterHD Flask endpoint, deploy/otterhd_endpoint
    .py:62-98, gains controller registration/heartbeat and streaming)."""
    from transformers import AutoTokenizer
    from otter_tpu_torch.data.fuyu_processor import (FuyuImageProcessor,
                                                     FuyuProcessor)
    cfg = _load_config(args.config, "fuyu")
    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    model, cfg = load_fuyu_model(args.checkpoint, cfg,
                                 load_bit=args.load_bit,
                                 quant_embed=args.quant_embed, device=device)
    processor = FuyuProcessor(
        tokenizer, FuyuImageProcessor(patch_size=cfg.patch_size),
        image_placeholder_id=cfg.image_placeholder_id,
        image_newline_id=cfg.image_newline_id)
    resolution = None
    if args.fuyu_resolution:
        h, w = args.fuyu_resolution.lower().split("x")
        resolution = (int(h), int(w))
    cache = CACHE_DTYPES[args.cache_bit]
    stream_worker(make_fuyu_stream_fn(
        model, processor, cfg, tokenizer, resolution=resolution,
        cache_dtype=None if cache == torch.bfloat16 else cache))


def main(argv=None):
    import argparse
    from otter_tpu_torch.config import PRESETS
    from otter_tpu_torch.device import resolve_device
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=21002)
    p.add_argument("--controller-address", default="http://localhost:21001")
    p.add_argument("--worker-address", default=None)
    p.add_argument("--model-name", default="otter")
    p.add_argument("--checkpoint", required=True,
                   help="HF-format checkpoint file or directory of shards "
                        "(.bin, .pt, .safetensors)")
    p.add_argument("--config", default="mpt7b",
                   help=f"otter family: one of {sorted(PRESETS)}; any "
                        "family: a config JSON (config.save_config; the "
                        "fuyu family defaults to adept/fuyu-8b's, the "
                        "idefics family to idefics-9b's)")
    p.add_argument("--model-family", default="otter",
                   choices=["otter", "idefics", "fuyu"],
                   help="otter: Flamingo-style VLM presets; idefics: HF "
                        "IdeficsForVisionText2Text checkpoints (int8/int4 "
                        "quantize the decoder layers only); fuyu: "
                        "Fuyu/OtterHD (adept/fuyu-8b-style) checkpoints")
    p.add_argument("--fuyu-resolution", default=None,
                   help="fixed HxW (e.g. 448x448) instead of bucketed "
                        "variable resolution (OtterHD serves high-res)")
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--limit-model-concurrency", type=int, default=5)
    p.add_argument("--load-bit", default="bf16",
                   choices=["bf16", "fp32", "int8", "int4"],
                   help="int8: weight-only int8 decoder and xattn kernels; "
                        "int4: additionally nibble-packs un-biased "
                        "two-matmul MLP pairs (0.5 B/weight; silu_glu and "
                        "biased archs stay int8). fp32 runs on the CPU "
                        "only: the CUDA kernels take bf16")
    p.add_argument("--cache-bit", default="bf16",
                   choices=["bf16", "int8", "int4"],
                   help="int8 quantizes the KV cache (per-position max-abs "
                        "scales, dequantized in the decode kernel); int4 "
                        "nibble-packs k and v into one byte")
    p.add_argument("--quant-embed", action="store_true",
                   help="fuyu family: store the embedding table as int8 "
                        "rows (the 262k-row bf16 table is 2.15 GB)")
    p.add_argument("--no-register", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="the GPU by default; raises without one unless "
                        "another device (cpu) is named")
    p.add_argument("--continuous-batching", action="store_true",
                   help="otter and idefics families: multiplex concurrent "
                        "requests through one shared decode step (slot "
                        "pool) instead of taking turns")
    p.add_argument("--num-slots", type=int, default=4)
    p.add_argument("--prefill-chunk", type=int, default=256, metavar="C",
                   help="continuous batching (otter family): split long "
                        "prompt prefills into C-token cache-append steps "
                        "interleaved with decode iterations, bounding "
                        "every active stream's admission stall at one "
                        "chunk instead of the whole prompt; 0 = one-shot "
                        "prefill")
    p.add_argument("--cache-len", type=int, default=2048)
    p.add_argument("--session-cache", type=int, default=0, metavar="N",
                   help="otter family: keep up to N conversations' KV "
                        "caches between turns (a request with a session_id "
                        "prefills only what its session does not hold); "
                        "each pins a --cache-len cache on the card. 0 "
                        "disables. Incompatible with --continuous-batching")
    p.add_argument("--draft-checkpoint", default=None,
                   help="otter family: a checkpoint of a small draft of the "
                        "target's vocabulary: greedy and sampled requests "
                        "decode speculatively (greedy output exact, sampled "
                        "distributionally exact); with --session-cache the "
                        "two compose per session_id")
    p.add_argument("--draft-config", default="mpt1b",
                   help=f"the draft's config: one of {sorted(PRESETS)} or a "
                        "config JSON")
    p.add_argument("--draft-gamma", type=int, default=4,
                   help="draft tokens a verify round (the most, with "
                        "--spec-adaptive)")
    p.add_argument("--spec-adaptive", dest="spec_adaptive",
                   action="store_true", default=True,
                   help="continuous batching with a draft: pick gamma, "
                        "gamma // 2 or plain decode by the measured tokens "
                        "a second (default)")
    p.add_argument("--no-spec-adaptive", dest="spec_adaptive",
                   action="store_false",
                   help="speculate at --draft-gamma always")
    args = p.parse_args(argv)

    if args.continuous_batching and args.session_cache > 0:
        p.error("--session-cache is incompatible with "
                "--continuous-batching: slots share one pooled KV "
                "cache, so cross-turn prefix reuse is unavailable. "
                "Drop one of the two flags.")
    if args.continuous_batching and args.model_family == "fuyu":
        p.error("--continuous-batching serves the otter and idefics "
                "families; the fuyu family decodes through fuyu_generate")
    device = resolve_device(args.device)
    if args.load_bit == "fp32" and device.type == "cuda":
        p.error("--load-bit fp32 on a CUDA device: the kernels take bf16 "
                "activations only; use bf16, int8 or int4")

    def stream_worker(stream_fn):
        from aiohttp import web
        addr = args.worker_address or f"http://localhost:{args.port}"
        worker = ModelWorker(
            controller_addr=args.controller_address, worker_addr=addr,
            model_name=args.model_name, stream_fn=stream_fn,
            limit_model_concurrency=args.limit_model_concurrency,
            no_register=args.no_register)
        web.run_app(build_app(worker), host=args.host, port=args.port)

    if args.model_family == "fuyu":
        _run_fuyu_worker(args, device, stream_worker)
        return
    from transformers import AutoTokenizer
    from otter_tpu_torch.generation.engine import OtterGenerator
    cfg = _load_config(args.config, args.model_family)
    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    load, make_stream_fn = (
        (load_idefics_model, make_idefics_stream_fn)
        if args.model_family == "idefics"
        else (load_otter_model, make_otter_stream_fn))
    model, cfg = load(args.checkpoint, cfg, load_bit=args.load_bit,
                      device=device)
    cache_dtype = CACHE_DTYPES[args.cache_bit]
    draft = None
    if args.draft_checkpoint and args.model_family == "otter":
        draft, _ = load_otter_model(
            args.draft_checkpoint, _load_config(args.draft_config, "otter"),
            load_bit=args.load_bit, device=device)
    if args.continuous_batching:
        stream_worker(_batched_stream_fn(args, model, cfg, tokenizer,
                                         cache_dtype, draft))
        return
    engine = OtterGenerator(model, cache_dtype=cache_dtype)
    if args.model_family != "otter":
        stream_worker(make_stream_fn(engine, tokenizer, cfg))
        return
    stream_worker(make_otter_stream_fn(
        engine, tokenizer, cfg,
        **_session_and_spec(args, model, draft, cache_dtype)))


def _session_and_spec(args, model, draft, cache_dtype) -> dict:
    """The stateless otter worker's `sessions`, `spec` and `spec_sessions`
    (`make_otter_stream_fn`), as the JAX worker builds them: the session
    pool with `--session-cache`, the speculative generator with a draft,
    and with both a pool of speculative sessions (the plain pool still
    serves the session requests that speculation does not take)."""
    from otter_tpu_torch.generation.session import (SessionPool,
                                                    SpecChatSession)
    from otter_tpu_torch.generation.speculative import SpeculativeGenerator
    out = {}
    if args.session_cache > 0:
        out["sessions"] = SessionPool(
            model, max_sessions=args.session_cache, cache_len=args.cache_len,
            cache_dtype=cache_dtype)
    if draft is not None:
        spec = out["spec"] = SpeculativeGenerator(
            model, draft, gamma=args.draft_gamma, cache_dtype=cache_dtype)
        if args.session_cache > 0:
            out["spec_sessions"] = SessionPool(
                model, max_sessions=args.session_cache,
                factory=lambda: SpecChatSession(spec,
                                                cache_len=args.cache_len))
    return out


def _batched_stream_fn(args, model, cfg, tokenizer, cache_dtype,
                       draft=None):
    """`--continuous-batching`: one `ContinuousBatcher` over the model,
    with the family's normalization; with a draft, its pooled iterations
    are speculative rounds. The idefics family prefills in one shot, as
    the JAX worker builds its batcher."""
    from otter_tpu_torch.generation.batching import ContinuousBatcher
    kw, norm = {}, {}
    if args.model_family == "idefics":
        from otter_tpu_torch.data.templates import (IDEFICS_STANDARD_MEAN,
                                                    IDEFICS_STANDARD_STD)
        norm = dict(mean=IDEFICS_STANDARD_MEAN, std=IDEFICS_STANDARD_STD)
    else:
        kw = dict(prefill_chunk=args.prefill_chunk, draft=draft,
                  spec_gamma=args.draft_gamma,
                  spec_adaptive=args.spec_adaptive)
    batcher = ContinuousBatcher(model, num_slots=args.num_slots,
                                cache_len=args.cache_len,
                                cache_dtype=cache_dtype, **kw)
    return make_batched_stream_fn(batcher, tokenizer, cfg, **norm)


if __name__ == "__main__":
    main()
