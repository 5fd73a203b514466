"""Port parity: the serving stack (`otter_tpu_torch/serve/`, with
`data/templates.py` and `data/fuyu_processor.py`) against the JAX package's
`tests/test_serve.py` surface. The copied modules (controller, web UI,
conversation templates, moderation gate, Fuyu processor) give the
originals' output; the worker's otter, idefics and fuyu stream functions
serve over localhost HTTP the greedy text of the JAX worker's for the same
requests on the same weights; concurrent requests equal each alone; the
flags whose machinery is not ported refuse at start; `python -m
otter_tpu_torch.serve.worker --device cpu` serves an otter and an idefics
checkpoint and a tokenizer made in the test."""

import base64
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TinyTokenizer
from otter_tpu.generation.engine import OtterGenerator as JaxGenerator
from otter_tpu.serve import controller as jcontroller
from otter_tpu.serve import conversation as jconversation
from otter_tpu.serve import worker as jworker
from otter_tpu_torch.config import GenerationConfig
from otter_tpu_torch.generation.engine import OtterGenerator
from otter_tpu_torch.serve import cli, controller, conversation, worker
from otter_tpu_torch.serve.worker import (ModelWorker, build_app,
                                          make_otter_stream_fn,
                                          run_app_in_thread)
from torch_parity_helpers import fuyu_pair, idefics_pair, jax_tiny, torch_tiny

ROOT = Path(__file__).resolve().parents[1]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(app):
    """(base url, stop) of `app` served on a free localhost port."""
    port = _free_port()
    return f"http://127.0.0.1:{port}", run_app_in_thread(app, "127.0.0.1",
                                                         port)


def _stream(url, payload, timeout=120):
    import requests
    r = requests.post(url + "/worker_generate_stream", json=payload,
                      stream=True, timeout=timeout)
    return [json.loads(c) for c in
            r.iter_lines(decode_unicode=False, delimiter=b"\0") if c]


def _png(seed, size=28):
    from PIL import Image
    arr = (np.random.default_rng(seed).random((size, size, 3)) * 255
           ).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return base64.urlsafe_b64encode(buf.getvalue()).decode()


# ── the copied modules ───────────────────────────────────────────────

def test_controller_registry_and_dispatch_match_jax():
    """The same calls on the copy and on the original: the same answers
    and the same registry, expiry included."""
    statuses = {"http://w1": {"model_names": ["otter"], "speed": 1,
                              "queue_length": 0},
                "http://w2": {"model_names": ["otter", "hd"], "speed": 2,
                              "queue_length": 5}}

    def drive(mod):
        c = mod.Controller("shortest_queue", status_fetcher=statuses.get)
        out = [c.register_worker("http://w1", True, None),
               c.register_worker("http://w2", True, statuses["http://w2"]),
               c.register_worker("http://w3", True, None),
               sorted(c.list_models()),
               c.get_worker_address("otter"), c.get_worker_address("hd"),
               c.get_worker_address("nope"),
               c.receive_heart_beat("http://w1", 3),
               c.receive_heart_beat("http://unknown", 0),
               c.worker_api_get_status()["queue_length"]]
        c.worker_info["http://w2"].last_heart_beat = time.time() - 10_000
        c.remove_stale_workers_by_expiration()
        out.append({n: (i.model_names, i.queue_length)
                    for n, i in c.worker_info.items()})
        return out

    got = drive(controller)
    assert got == drive(jcontroller)
    assert got[4] == "http://w1" and "http://w2" not in got[-1]


def test_controller_proxies_the_worker_stream():
    import requests

    def dummy_stream(params):
        yield "hello "
        yield "hello " + params["prompt"]

    w = ModelWorker(controller_addr="", worker_addr="", model_name="otter",
                    stream_fn=dummy_stream, no_register=True)
    wurl, wstop = _serve(build_app(w))
    curl, cstop = _serve(controller.build_app(controller.Controller(
        "lottery")))
    try:
        r = requests.post(curl + "/register_worker", json={
            "worker_name": wurl, "check_heart_beat": True,
            "worker_status": None}, timeout=10)
        assert r.json()["exist"]
        assert requests.post(curl + "/get_worker_address",
                             json={"model": "otter"},
                             timeout=5).json()["address"] == wurl
        assert requests.post(wurl + "/worker_get_status", timeout=5
                             ).json()["model_names"] == ["otter"]
        chunks = _stream(curl, {"model": "otter", "prompt": "world"})
        assert [c["text"] for c in chunks] == ["hello ", "hello world"]
        assert all(c["error_code"] == 0 for c in chunks)
        bad = _stream(curl, {"model": "missing", "prompt": "x"})
        assert bad[-1]["error_code"] == 2
    finally:
        cstop()
        wstop()


def test_worker_reports_stream_errors_as_jax_does():
    def failing(params):
        yield "partial"
        raise ValueError("prompt too long")

    def crashing(params):
        raise KeyError("x")
        yield

    for fn in (failing, crashing):
        got = [json.loads(c[:-1]) for c in ModelWorker(
            controller_addr="", worker_addr="", model_name="m",
            stream_fn=fn, no_register=True).generate_stream_gate({})]
        ref = [json.loads(c[:-1]) for c in jworker.ModelWorker(
            controller_addr="", worker_addr="", model_name="m",
            stream_fn=fn, no_register=True).generate_stream_gate({})]
        assert got == ref and got[-1]["error_code"] == 1


@pytest.mark.parametrize("media", ["still", "video", "mixed"])
def test_decode_media_matches_jax(media):
    still, frames = _png(1, 10), [_png(s, 10) for s in (2, 3, 4)]
    images = {"still": [still, still], "video": [frames],
              "mixed": [still, frames]}[media]
    vx, mask = worker.decode_media_to_vision_x(images, patch_size=16)
    rvx, rmask = jworker.decode_media_to_vision_x(images, patch_size=16)
    np.testing.assert_array_equal(vx, rvx)
    np.testing.assert_array_equal(mask, rmask)
    assert vx.dtype == np.float32 and mask.dtype == bool
    assert worker.decode_media_to_vision_x([], 16) == (None, None)
    np.testing.assert_array_equal(
        worker.decode_images_to_vision_x(images, patch_size=16), rvx)


def test_templates_and_prompts_match_jax():
    from otter_tpu.data import templates as jt
    from otter_tpu_torch.data import templates as tt
    for fmt in ("simple", "llama2", "idefics", "fuyu"):
        for kw in ({}, {"insert_image": True},
                   {"insert_image": True, "is_text_only": True}):
            assert tt.format_pair("q?", "a.", fmt, **kw) == \
                jt.format_pair("q?", "a.", fmt, **kw)
    for fmt in ("simple", "llama2", "fuyu"):
        for img in (True, False):
            assert tt.inference_prompt("what?", fmt, insert_image=img) == \
                jt.inference_prompt("what?", fmt, insert_image=img)
    for keep in (True, False):
        text = "  Is\\r\\n this <ok> #1?  "
        assert tt.pre_question(text, keep) == jt.pre_question(text, keep)
        assert tt.pre_answer(text, keep) == jt.pre_answer(text, keep)
    assert (tt.FLAMINGO_MEAN, tt.IDEFICS_STANDARD_STD, tt.LLAMA2_SYS) == \
        (jt.FLAMINGO_MEAN, jt.IDEFICS_STANDARD_STD, jt.LLAMA2_SYS)
    chats = [[["what is this?", None]], [["q1", "a1"], ["q2", None]]]
    for template in ("otter", "idefics"):
        for messages in chats:
            for img in (True, False):
                assert conversation.render_prompt(template, messages, img) \
                    == jconversation.render_prompt(template, messages, img)
    for name, conv in conversation.conv_templates.items():
        c, r = conv.copy(), jconversation.conv_templates[name].copy()
        for x in (c, r):
            x.append_message(x.roles[0], "hi")
            x.append_message(x.roles[1], "hello")
            x.append_message(x.roles[0], ("more", None))
            x.append_message(x.roles[1], None)
        assert c.get_prompt() == r.get_prompt()
        assert c.to_gradio_chatbot() == r.to_gradio_chatbot()
        assert c.dict() == r.dict()


def test_fuyu_processor_matches_jax():
    from PIL import Image
    from otter_tpu.data import fuyu_processor as jfp
    from otter_tpu_torch.data import fuyu_processor as tfp

    class Tok(TinyTokenizer):
        specials = dict(TinyTokenizer.specials, **{"\x04": 250})

    img = Image.fromarray((np.random.default_rng(0).random((23, 37, 3))
                           * 255).astype(np.uint8))
    outs = []
    for mod in (tfp, jfp):
        proc = mod.FuyuProcessor(Tok(), mod.FuyuImageProcessor(
            patch_size=10, buckets=((20, 30), (40, 40))),
            image_placeholder_id=508, image_newline_id=509)
        batch = proc(["describe \x04", "hi"], [img, None], left_pad=True)
        labels = proc.get_labels(batch["input_ids"], special_token_id=250)
        outs.append((batch, labels, proc.post_process_box_coordinates(
            "a <box>10, 20, 30, 40</box> <point>5, 6</point>")))
    (b, lab, box), (rb, rlab, rbox) = outs
    assert set(b) == set(rb)
    for k in b:
        np.testing.assert_array_equal(b[k], rb[k])
    np.testing.assert_array_equal(lab, rlab)
    assert box == rbox == "a <box>20, 40, 60, 80</box> <point>10, 12</point>"


def test_web_ui_endpoints(tmp_path):
    """The web app: landing page, /list_models through the controller,
    multi-turn /http_bot rendered server-side, vote and conversation logs
    (as `tests/test_serve.py` drives the original)."""
    import requests
    from otter_tpu_torch.serve.web import build_app as web_app
    seen = []

    def dummy_stream(params):
        seen.append(params["prompt"])
        yield "the answer"

    w = ModelWorker(controller_addr="", worker_addr="", model_name="otter",
                    stream_fn=dummy_stream, no_register=True)
    wurl, wstop = _serve(build_app(w))
    c = controller.Controller("lottery")
    c.register_worker(wurl, False, {"model_names": ["otter"], "speed": 1,
                                    "queue_length": 0})
    curl, cstop = _serve(controller.build_app(c))
    log_dir = str(tmp_path / "logs")
    base, gstop = _serve(web_app(curl, log_dir=log_dir))
    try:
        assert "Otter-TPU Chat" in requests.get(base + "/", timeout=5).text
        assert requests.get(base + "/list_models",
                            timeout=5).json()["models"] == ["otter"]
        r = requests.post(base + "/http_bot", json={
            "model": "otter", "template": "otter",
            "messages": [["q1", "a1"], ["q2", None]], "images": ["x"],
            "generation_kwargs": {"max_new_tokens": 4}}, timeout=30)
        chunks = [json.loads(x) for x in r.content.split(b"\0") if x]
        assert chunks[-1] == {"text": "the answer", "error_code": 0}
        assert seen[-1] == ("<image>User: q1 GPT:<answer>a1<|endofchunk|>"
                            "User: q2 GPT:<answer>")
        r = requests.post(base + "/vote", json={
            "type": "upvote", "model": "otter", "messages": [["q", "a"]]},
            timeout=5)
        assert r.json()["ok"]
        files = os.listdir(log_dir)
        assert any("votes" in f for f in files) and \
            any("conv" in f for f in files)
    finally:
        gstop()
        cstop()
        wstop()


def test_web_moderation_gate(tmp_path):
    """Flagged text is blocked before any worker call; without an API key
    the check is a no-op (fails open), as the original's."""
    import requests
    from otter_tpu.serve.moderation import violates_moderation as jviolates
    from otter_tpu_torch.serve.moderation import (MODERATION_MSG,
                                                  violates_moderation)
    from otter_tpu_torch.serve.web import build_app as web_app
    assert violates_moderation("anything", api_key=None) is False \
        is jviolates("anything", api_key=None)
    base, stop = _serve(web_app("http://127.0.0.1:1",
                                log_dir=str(tmp_path / "l"), moderate=True,
                                moderation_fn=lambda t: "bad" in t))
    try:
        r = requests.post(base + "/http_bot", json={
            "model": "otter", "messages": [["something bad", None]],
            "images": [], "generation_kwargs": {}}, timeout=10)
        chunks = [json.loads(x) for x in r.content.split(b"\0") if x]
        assert chunks[-1]["error_code"] == 3
        assert MODERATION_MSG in chunks[-1]["text"]
    finally:
        stop()


# ── the worker's stream functions on the tiny models ─────────────────

@pytest.fixture(scope="module")
def otter_pair():
    """The JAX worker's otter stream function on the tiny int8 model and
    an int8 cache, and the port's engine on the same weights."""
    cfg, jmodel, params, _ = jax_tiny()
    tok = TinyTokenizer()
    jfn = jworker.make_otter_stream_fn(
        JaxGenerator(jmodel, params, cfg, cache_dtype="int8"), tok, cfg)
    engine = OtterGenerator(torch_tiny(), cache_dtype=torch.int8)
    return cfg, tok, jfn, engine


def _otter_requests():
    still, frames = _png(11), [_png(s) for s in (12, 13, 14)]
    prompt = "<image>User: alpha beta gamma tell me GPT:<answer>"
    return [
        {"prompt": prompt, "images": [still],
         "generation_kwargs": {"max_new_tokens": 6}},
        # a still and a 3-frame video: the frame mask reaches the perceiver
        {"prompt": "<image>one two<image>" + prompt, "images":
         [still, frames], "generation_kwargs": {"max_new_tokens": 5}},
        # no image: the zero-image branch
        {"prompt": "User: no picture here GPT:<answer>",
         "generation_kwargs": {"max_new_tokens": 4}},
    ]


def test_otter_stream_over_http_matches_jax_worker(otter_pair):
    cfg, tok, jfn, engine = otter_pair
    w = ModelWorker(controller_addr="", worker_addr="", model_name="otter",
                    stream_fn=make_otter_stream_fn(engine, tok, cfg),
                    no_register=True)
    url, stop = _serve(build_app(w))
    try:
        for req in _otter_requests():
            chunks = _stream(url, req)
            assert all(c["error_code"] == 0 for c in chunks), chunks
            want = list(jfn(req))
            assert [c["text"] for c in chunks] == want
            assert want[-1]
    finally:
        stop()


def test_concurrent_requests_equal_each_alone(otter_pair):
    """Three requests at once over HTTP (each decoding on its own executor
    thread): the same chunks as each alone."""
    cfg, tok, _, engine = otter_pair
    w = ModelWorker(controller_addr="", worker_addr="", model_name="otter",
                    stream_fn=make_otter_stream_fn(engine, tok, cfg),
                    no_register=True)
    url, stop = _serve(build_app(w))
    reqs = _otter_requests()
    try:
        alone = [_stream(url, r) for r in reqs]
        results = [None] * len(reqs)
        barrier = threading.Barrier(len(reqs))

        def run(i):
            barrier.wait()
            results[i] = _stream(url, reqs[i])

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert results == alone
    finally:
        stop()


def test_beam_and_sampled_streams(otter_pair):
    """Beams stream the best beam, ending in `generate(num_beams=K)`'s
    text; a sampled request draws from a generator seeded alike for every
    request, so two equal requests give equal text."""
    cfg, tok, _, engine = otter_pair
    fn = make_otter_stream_fn(engine, tok, cfg)
    req = dict(_otter_requests()[0], generation_kwargs={
        "max_new_tokens": 6, "num_beams": 3, "no_repeat_ngram_size": 2})
    chunks = list(fn(req))
    vx, _ = worker.decode_media_to_vision_x(req["images"], 28)
    ids = tok(req["prompt"], return_tensors="np")["input_ids"]
    out = engine.generate(vx, ids, gen=GenerationConfig(
        max_new_tokens=6, num_beams=3, no_repeat_ngram_size=2))
    toks = out[0, ids.shape[1]:].tolist()
    if cfg.eoc_token_id in toks:
        toks = toks[:toks.index(cfg.eoc_token_id)]
    assert chunks[-1] == tok.decode(toks)
    sampled = dict(req, generation_kwargs={
        "max_new_tokens": 6, "do_sample": True, "temperature": 1.5})
    assert list(fn(sampled)) == list(fn(sampled))


@pytest.mark.parametrize("box", [False, True])
def test_fuyu_stream_over_http_matches_jax_worker(box):
    """The fuyu stream function over HTTP (an image through the bucketed
    processor, `fuyu_generate`, coordinate post-processing) gives the JAX
    worker's text on the same weights; with a tokenizer that decodes a
    box span, the span rescaled from half-scale token space."""
    from otter_tpu.data import fuyu_processor as jfp
    from otter_tpu_torch.data import fuyu_processor as tfp

    class FuyuTok(TinyTokenizer):
        specials = dict(TinyTokenizer.specials, **{"\x04": 250})

        def decode(self, ids, skip_special_tokens=True):
            text = super().decode(ids, skip_special_tokens)
            return f"{text} <box>10, 20, 30, 40</box>" if box else text

    cfg, jmodel, params, tmodel = fuyu_pair()
    tok = FuyuTok()

    def processor(mod):
        return mod.FuyuProcessor(
            tok, mod.FuyuImageProcessor(patch_size=cfg.patch_size,
                                        buckets=((16, 16),)),
            image_placeholder_id=cfg.image_placeholder_id,
            image_newline_id=cfg.image_newline_id)

    jfn = jworker.make_fuyu_stream_fn(jmodel, params, processor(jfp), cfg,
                                      tok)
    tfn = worker.make_fuyu_stream_fn(tmodel, processor(tfp), cfg, tok)
    w = ModelWorker(controller_addr="", worker_addr="", model_name="otterhd",
                    stream_fn=tfn, no_register=True)
    url, stop = _serve(build_app(w))
    try:
        for req in ({"prompt": "describe \x04", "images": [_png(21, 16)],
                     "generation_kwargs": {"max_new_tokens": 5}},
                    {"prompt": "just text \x04",
                     "generation_kwargs": {"max_new_tokens": 4}}):
            chunks = _stream(url, req)
            assert all(c["error_code"] == 0 for c in chunks), chunks
            assert [c["text"] for c in chunks] == list(jfn(req))
            if box:
                assert "<box>20, 40, 60, 80</box>" in chunks[-1]["text"]
    finally:
        stop()


class IdeficsTok(TinyTokenizer):
    """TinyTokenizer with the tiny idefics config's image token."""
    specials = {"<image>": 126, "<answer>": 125, "<PAD>": 0}


def test_idefics_stream_over_http_matches_jax_worker():
    """The idefics stream function over HTTP (stills at the IDEFICS
    mean/std stacked along N, `stream_generate` over the tiny IdeficsVLM
    with int8 decoder layers and an int8 cache) gives the text of the JAX
    worker's `make_idefics_stream_fn` on the same weights: one image, two
    images interleaved with text, none (one zero image)."""
    cfg, jmodel, params, tmodel = idefics_pair("int8")
    tok = IdeficsTok()
    jfn = jworker.make_idefics_stream_fn(
        JaxGenerator(jmodel, params, cfg, cache_dtype="int8"), tok, cfg)
    tfn = worker.make_idefics_stream_fn(
        OtterGenerator(tmodel, cache_dtype=torch.int8), tok, cfg)
    w = ModelWorker(controller_addr="", worker_addr="", model_name="idefics",
                    stream_fn=tfn, no_register=True)
    url, stop = _serve(build_app(w))
    prompt = "User:<image> alpha beta gamma tell me Assistant:"
    try:
        for req in ({"prompt": prompt, "images": [_png(41)],
                     "generation_kwargs": {"max_new_tokens": 6}},
                    {"prompt": "<image> one two " + prompt,
                     "images": [_png(42), _png(43)],
                     "generation_kwargs": {"max_new_tokens": 5}},
                    {"prompt": "User: no picture here Assistant:",
                     "generation_kwargs": {"max_new_tokens": 4}}):
            chunks = _stream(url, req)
            assert all(c["error_code"] == 0 for c in chunks), chunks
            want = list(jfn(req))
            assert [c["text"] for c in chunks] == want
            assert want[-1]
    finally:
        stop()


def test_batched_stream_fn_matches_jax_worker(tmp_path):
    """`make_batched_stream_fn` over the port's `ContinuousBatcher` (tiny
    int8 model, int8 cache, two slots), served over HTTP with two requests
    at once, gives the texts of the JAX worker's `make_batched_stream_fn`
    over the JAX batcher on the same weights, with the same word-level
    tokenizer; `/worker_get_status` carries the batcher's stats."""
    from transformers import AutoTokenizer
    from otter_tpu.generation.batching import \
        ContinuousBatcher as JaxBatcher
    from otter_tpu_torch.generation.batching import ContinuousBatcher
    cfg, jmodel, params, _ = jax_tiny()
    tok = AutoTokenizer.from_pretrained(_tokenizer_dir(tmp_path, cfg))
    kw = dict(num_slots=2, cache_len=64, buckets=(16,))
    jb = JaxBatcher(jmodel, params, cfg, cache_dtype="int8", **kw)
    tb = ContinuousBatcher(torch_tiny(), cache_dtype=torch.int8, **kw)
    reqs = [{"prompt": "<image> w5 w17 w99 w3 w60", "images": [_png(33)],
             "generation_kwargs": {"max_new_tokens": 6}},
            {"prompt": "w8 w9 w10 w11",
             "generation_kwargs": {"max_new_tokens": 5}}]
    w = ModelWorker(controller_addr="", worker_addr="", model_name="otter",
                    stream_fn=worker.make_batched_stream_fn(tb, tok, cfg),
                    no_register=True)
    url, stop = _serve(build_app(w))
    try:
        jfn = jworker.make_batched_stream_fn(jb, tok, cfg)
        want = [list(jfn(r)) for r in reqs]
        results = [None] * 2
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, _stream(url, reqs[i]))) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        for chunks, texts in zip(results, want):
            assert all(c["error_code"] == 0 for c in chunks), chunks
            assert [c["text"] for c in chunks] == texts and texts[-1]
        import requests
        status = requests.post(url + "/worker_get_status", timeout=30).json()
        assert status["batching"]["completed"] == 2
        assert set(status["batching"]) == set(jb.stats())
    finally:
        stop()
        jb.shutdown()
        tb.shutdown()


# ── the worker's session and speculative routes ─────────────────────

SESSION_KW = dict(cache_len=128, prompt_bucket=16, window_bucket=8,
                  min_reuse=4)


def _conversation(stream_fn, first: dict, turns: int = 3, sid="s1"):
    """Each turn's chunks through `stream_fn`: the prompt grows by the
    reply's text and a new user turn, under one session id."""
    req, texts = dict(first, session_id=sid), []
    for t in range(turns):
        texts.append(list(stream_fn(req)))
        req = dict(req, prompt=req["prompt"] + " " + texts[-1][-1]
                   + f"<|endofchunk|>User: and then {t} more GPT:<answer>")
    return texts


@pytest.fixture(scope="module")
def spec_worker():
    """The JAX worker's and the port's otter stream functions with a
    session pool, a speculative generator (the tiny f32 MPT target, the
    2-layer mosaic_gpt draft, gamma 3) and a pool of speculative sessions,
    and the port's stateless stream function, with TinyTokenizer."""
    from otter_tpu.generation import session as jsession
    from otter_tpu.generation import speculative as jspec
    from otter_tpu_torch.generation import session, speculative
    from torch_parity_helpers import spec_pair
    (cfg, jm, jp, tm), (cfg_d, jm_d, jp_d, tm_d) = spec_pair("mpt")
    tok = TinyTokenizer()
    jsg = jspec.SpeculativeGenerator(jm, jp, cfg, jm_d, jp_d, cfg_d, gamma=3,
                                     cache_dtype=jnp.float32)
    jfn = jworker.make_otter_stream_fn(
        JaxGenerator(jm, jp, cfg, cache_dtype=jnp.float32), tok, cfg,
        sessions=jsession.SessionPool(jm, jp, cfg, max_sessions=2,
                                      cache_dtype=jnp.float32, **SESSION_KW),
        spec=jsg, spec_sessions=jsession.SessionPool(
            jm, jp, cfg, max_sessions=2, factory=lambda: (
                jsession.SpecChatSession(jsg, **SESSION_KW))))
    engine = OtterGenerator(tm, cache_dtype=torch.float32)
    sg = speculative.SpeculativeGenerator(tm, tm_d, gamma=3,
                                          cache_dtype=torch.float32)
    pools = dict(
        sessions=session.SessionPool(tm, max_sessions=2,
                                     cache_dtype=torch.float32, **SESSION_KW),
        spec_sessions=session.SessionPool(tm, max_sessions=2, factory=lambda: (
            session.SpecChatSession(sg, **SESSION_KW))))
    tfn = make_otter_stream_fn(engine, tok, cfg, spec=sg, **pools)
    return cfg, jfn, tfn, make_otter_stream_fn(engine, tok, cfg), pools


def test_session_and_spec_routes_match_jax_worker(spec_worker):
    """Three turns under one session id (the speculative session), a
    session request with a bigram ban (the plain session: speculation
    takes no bans), a request without a session (the speculative
    generator) and a beam request (the engine): the JAX worker's texts
    with the same routes, and the port's stateless worker's."""
    cfg, jfn, tfn, plain, pools = spec_worker
    first = {"prompt": "<image>User: alpha beta gamma delta tell me "
                       "GPT:<answer>", "images": [_png(41)],
             "generation_kwargs": {"max_new_tokens": 6}}
    got = _conversation(tfn, first)
    assert got == _conversation(jfn, first)
    stateless = []
    for t, texts in enumerate(got):
        req = dict(first, prompt=first["prompt"] + "".join(
            " " + got[i][-1] + f"<|endofchunk|>User: and then {i} more "
            "GPT:<answer>" for i in range(t)))
        stateless.append(list(plain(req)))
    assert got == stateless and all(t[-1] for t in got)
    sess = pools["spec_sessions"].get("s1")
    assert not sess.last_stats["restart"] and sess.last_stats["reused"] > 16
    banned = dict(first, session_id="s2", generation_kwargs={
        "max_new_tokens": 6, "no_repeat_ngram_size": 2})
    assert list(tfn(banned)) == list(jfn(banned)) == list(plain(banned))
    assert pools["sessions"].get("s2").last_stats["restart"]
    for req in (first, dict(first, generation_kwargs={
            "max_new_tokens": 5, "num_beams": 2})):
        assert list(tfn(req)) == list(jfn(req)) == list(plain(req))


def test_same_session_twice_at_once_takes_the_stateless_path(spec_worker):
    """A second request with a session id whose session a running stream
    holds takes the stateless path (the JAX worker would advance the one
    session's cache from both): both texts are the stateless worker's, and
    the session holds the first request's conversation only."""
    cfg, _, tfn, plain, pools = spec_worker
    req = {"prompt": "<image>User: one two three four five six seven "
                     "GPT:<answer>", "images": [_png(42)],
           "session_id": "shared", "generation_kwargs": {"max_new_tokens": 8}}
    other = dict(req, prompt=req["prompt"].replace("seven", "eight nine"))
    first = tfn(req)
    head = next(first)                       # the first stream holds it
    second = list(tfn(other))
    rest = list(first)
    assert [head] + rest == list(plain(req))
    assert second == list(plain(other))
    sess = pools["spec_sessions"].get("shared")
    assert sess.last_stats["restart"]
    assert pools["spec_sessions"].acquire("shared") is sess
    pools["spec_sessions"].release(sess)


def test_cli_chat_loop_streams_text(otter_pair):
    """`chat_loop` through StringIO: two turns, each printing what
    `stream_generate` yields for the rendered prompt, then EOF."""
    from otter_tpu_torch.data.templates import inference_prompt
    cfg, tok, _, engine = otter_pair
    vision_x = np.zeros((1, 1, 1, 3, 28, 28), np.float32)
    gen = GenerationConfig(max_new_tokens=4, eos_token_id=-1)
    questions = iter(["what is this", "and now"])

    def input_fn(prompt):
        try:
            return next(questions)
        except StopIteration:
            raise EOFError

    out = io.StringIO()
    cli.chat_loop(engine, tok, vision_x, gen, with_image=True,
                  input_fn=input_fn, out=out)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("Otter-TPU CLI chat")
    replies = [l[len("GPT: "):] for l in lines if l.startswith("GPT: ")]
    want = []
    for q in ("what is this", "and now"):
        ids = tok(inference_prompt(q), return_tensors="np")["input_ids"]
        toks = list(engine.stream_generate(vision_x, ids, gen=gen))
        want.append(tok.decode(toks))
    assert replies == want and all(replies)


# ── the entry point ──────────────────────────────────────────────────

def _main_args(tmp_path, *extra):
    return ["--checkpoint", str(tmp_path / "none.bin"), "--tokenizer",
            str(tmp_path), *extra]


@pytest.mark.parametrize("flags,item", [
    (["--continuous-batching", "--draft-checkpoint", "draft.bin"],
     "item 6"),
    (["--session-cache", "4"], "item 6"),
    (["--draft-checkpoint", "draft.bin"], "item 6"),
])
def test_unported_flags_refuse_at_start(tmp_path, monkeypatch, capsys,
                                        flags, item):
    """Speculative decoding (once refused as ROADMAP Queue 1 item 6.2, with
    or without the batcher) and the session cache (item 6.3) now start: the
    target and the draft load through `load_otter_model` at the same
    `--load-bit`, and the stream function gets the batcher's draft, the
    session pool or the speculative generator, as the JAX worker builds
    them."""
    import aiohttp.web
    from otter_tpu_torch.generation.session import SessionPool
    from otter_tpu_torch.generation.speculative import SpeculativeGenerator
    model = torch_tiny()
    loaded, built = [], {}
    monkeypatch.setattr(worker, "load_otter_model", lambda ckpt, cfg, **kw: (
        loaded.append((os.path.basename(ckpt), kw["load_bit"]))
        or (model, model.cfg)))
    monkeypatch.setattr(aiohttp.web, "run_app", lambda app, **kw: None)
    for name in ("make_otter_stream_fn", "make_batched_stream_fn"):
        make = getattr(worker, name)
        monkeypatch.setattr(worker, name, lambda *a, _make=make, _name=name,
                            **kw: built.setdefault(_name, (a, kw)) and
                            _make(*a, **kw))
    tok_dir = _tokenizer_dir(tmp_path / "tok", model.cfg)
    worker.main(["--checkpoint", str(tmp_path / "target.bin"), "--tokenizer",
                 tok_dir, "--device", "cpu", "--no-register", "--load-bit",
                 "int8", *flags])
    assert f"ROADMAP Queue 1 {item}" not in capsys.readouterr().err
    want = [("target.bin", "int8")]
    if "--draft-checkpoint" in flags:
        want.append(("draft.bin", "int8"))
    assert loaded == want
    if "--continuous-batching" in flags:
        (batcher, _, _), _ = built["make_batched_stream_fn"]
        batcher.shutdown()
        assert batcher.model_d is model and batcher.gamma == 4 \
            and batcher.spec_adaptive
        return
    _, kw = built["make_otter_stream_fn"]
    if "--session-cache" in flags:
        assert isinstance(kw["sessions"], SessionPool) \
            and kw["sessions"].max_sessions == 4 and "spec" not in kw
    else:
        assert isinstance(kw["spec"], SpeculativeGenerator) \
            and kw["spec"].model_d is model and "sessions" not in kw


@pytest.mark.parametrize("flags,message", [
    (["--continuous-batching", "--session-cache", "2"],
     "--session-cache is incompatible with --continuous-batching: slots "
     "share one pooled KV cache, so cross-turn prefix reuse is "
     "unavailable. Drop one of the two flags."),
    (["--continuous-batching", "--model-family", "fuyu"],
     "--continuous-batching serves the otter and idefics families"),
])
def test_batching_flag_conflicts_refuse_at_start(tmp_path, capsys, flags,
                                                 message):
    """The session cache with the batcher gives the JAX worker's error
    (`otter_tpu/serve/worker.py`, its continuous-batching branch); the
    fuyu family, which the JAX worker serves without a word about the
    flag, refuses it."""
    with pytest.raises(SystemExit) as e:
        worker.main(_main_args(tmp_path, "--device", "cpu", *flags))
    assert e.value.code == 2
    assert message in " ".join(capsys.readouterr().err.split())


def test_fp32_refused_on_the_card(tmp_path, capsys, monkeypatch):
    from otter_tpu_torch import device as device_mod
    monkeypatch.setattr(device_mod, "resolve_device",
                        lambda d=None: torch.device("cuda"))
    with pytest.raises(SystemExit):
        worker.main(_main_args(tmp_path, "--load-bit", "fp32"))
    assert "bf16" in capsys.readouterr().err


@pytest.mark.parametrize("family,load_bit", [
    ("otter", "int8"), ("otter", "int4"), ("fuyu", "int8"),
    ("idefics", "int8")])
def test_worker_runs_on_the_card_by_default(tmp_path, family, load_bit):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the worker would start for real")
    with pytest.raises(RuntimeError, match="CUDA"):
        worker.main(_main_args(tmp_path, "--model-family", family,
                               "--load-bit", load_bit))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(_main_args(tmp_path))


def _tokenizer_dir(path, cfg):
    """A word-level HF tokenizer over the tiny vocabulary: `w<i>` is id i,
    the config's media and end-of-chunk tokens their ids."""
    vocab = {f"w{i}": i for i in range(cfg.eoc_token_id)}
    vocab.update({"<|endofchunk|>": cfg.eoc_token_id,
                  "<image>": cfg.media_token_id, "<unk>": 254, "</s>": 255})
    return _save_tokenizer(path, vocab, ["<image>", "<|endofchunk|>"])


def _save_tokenizer(path, vocab, specials):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast
    t = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    t.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    PreTrainedTokenizerFast(
        tokenizer_object=t, unk_token="<unk>", eos_token="</s>",
        additional_special_tokens=specials).save_pretrained(str(path))
    return str(path)


def _idefics_files(tmp_path):
    """(config, checkpoint, config JSON, tokenizer dir) of the tiny idefics
    model: random weights as an HF-named checkpoint, a word-level
    tokenizer with `w<i>` for the ordinary ids, <image> at the media id,
    </s> at eos."""
    from otter_tpu_torch.config import idefics_tiny
    from otter_tpu_torch.models.convert import port_to_hf, save_state_dict
    from otter_tpu_torch.tools.random_weights import RandomParams
    cfg = idefics_tiny()
    ckpt = str(tmp_path / "model.safetensors")
    save_state_dict(port_to_hf(RandomParams(cfg, "cpu", seed=5), cfg), ckpt)
    cfg_path = str(tmp_path / "config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    vocab = {f"w{i}": i for i in range(3, cfg.text.vocab_size)}
    vocab.update({"<image>": cfg.media_token_id, "<unk>": 127,
                  "</s>": cfg.eos_token_id})
    tok_dir = _save_tokenizer(tmp_path / "tok", vocab, ["<image>"])
    return cfg, ckpt, cfg_path, tok_dir


def test_idefics_family_loads_at_start(tmp_path, monkeypatch):
    """`--model-family idefics` (refused before the family was ported)
    starts: the config JSON, the checkpoint through `load_idefics_model`
    at `--load-bit int4` (the decoder layers int8, the head bf16), an
    engine and the worker's app, up to serving it."""
    import aiohttp.web
    from otter_tpu_torch.models.idefics import IdeficsVLM
    from otter_tpu_torch.ops.quant import Int8Dense
    cfg, ckpt, cfg_path, tok_dir = _idefics_files(tmp_path)
    loaded, served = [], []
    load = worker.load_idefics_model
    monkeypatch.setattr(worker, "load_idefics_model", lambda *a, **k: (
        loaded.append(load(*a, **k)) or loaded[-1]))
    monkeypatch.setattr(aiohttp.web, "run_app",
                        lambda app, **kw: served.append((app, kw)))
    worker.main(["--model-family", "idefics", "--device", "cpu",
                 "--no-register", "--config", cfg_path, "--checkpoint", ckpt,
                 "--tokenizer", tok_dir, "--load-bit", "int4", "--port",
                 "1234"])
    (model, mcfg), = loaded
    assert isinstance(model, IdeficsVLM) and mcfg.text.quant == "int4"
    assert mcfg.text.num_hidden_layers == cfg.text.num_hidden_layers
    assert isinstance(model.layers_0.ffn.gate_proj, Int8Dense)
    assert model.lm_head.kernel.dtype == torch.bfloat16
    assert len(served) == 1 and served[0][1]["port"] == 1234


def test_worker_entry_point_serves_a_checkpoint(tmp_path):
    """`python -m otter_tpu_torch.serve.worker --device cpu --no-register`
    from an HF checkpoint of the tiny model (its config as JSON) and a
    tokenizer saved in the test, at `--load-bit int8 --cache-bit int8`: one
    request over HTTP gives the text of the same start-up run in this
    process."""
    from transformers import AutoTokenizer
    from otter_tpu_torch.config import OtterConfig, save_config
    from otter_tpu_torch.models.convert import port_to_hf, save_state_dict
    from otter_tpu_torch.tools.random_weights import RandomParams
    cfg = OtterConfig.tiny("mpt")
    ckpt = str(tmp_path / "pytorch_model.bin")
    save_state_dict(port_to_hf(RandomParams(cfg, "cpu", seed=3), cfg), ckpt)
    cfg_path = str(tmp_path / "config.json")
    save_config(cfg, cfg_path)
    tok_dir = _tokenizer_dir(tmp_path / "tok", cfg)
    req = {"prompt": "<image> w5 w17 w99 w3", "images": [_png(31)],
           "generation_kwargs": {"max_new_tokens": 5}}
    chunks = _run_worker(["--config", cfg_path, "--checkpoint", ckpt,
                          "--tokenizer", tok_dir, "--load-bit", "int8",
                          "--cache-bit", "int8"], req)
    assert all(c["error_code"] == 0 for c in chunks), chunks
    model, mcfg = worker.load_otter_model(ckpt, cfg, load_bit="int8",
                                          device="cpu")
    fn = make_otter_stream_fn(OtterGenerator(model, cache_dtype=torch.int8),
                              AutoTokenizer.from_pretrained(tok_dir), mcfg)
    assert [c["text"] for c in chunks] == list(fn(req))


def _run_worker(args, req):
    """Start `python -m otter_tpu_torch.serve.worker --device cpu
    --no-register` with `args` on a free port, send `req` (or each of a
    list of requests, one after another), stop it; returns the chunks (a
    list of them a request for a list)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), HF_HUB_OFFLINE="1",
               TRANSFORMERS_OFFLINE="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "otter_tpu_torch.serve.worker", "--device",
         "cpu", "--no-register", "--host", "127.0.0.1", "--port", str(port),
         *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 240
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()[-3000:]
            try:
                socket.create_connection(("127.0.0.1", port), 0.5).close()
                break
            except OSError:
                assert time.time() < deadline, "the worker did not start"
                time.sleep(0.5)
        url = f"http://127.0.0.1:{port}"
        if isinstance(req, list):
            return [_stream(url, r) for r in req]
        return _stream(url, req)
    finally:
        proc.terminate()
        proc.wait(30)


def test_worker_entry_point_batches_an_idefics_checkpoint(tmp_path):
    """`--model-family idefics --continuous-batching --num-slots 2`: the
    worker serves through the batcher (stills at the IDEFICS mean/std), and
    a request's text equals the take-turns worker's on the same start-up
    run in this process."""
    from transformers import AutoTokenizer
    cfg, ckpt, cfg_path, tok_dir = _idefics_files(tmp_path)
    req = {"prompt": "w5 <image> w17 w99 w3", "images": [_png(34)],
           "generation_kwargs": {"max_new_tokens": 5}}
    chunks = _run_worker(["--model-family", "idefics", "--config", cfg_path,
                          "--checkpoint", ckpt, "--tokenizer", tok_dir,
                          "--load-bit", "int8", "--cache-bit", "int8",
                          "--continuous-batching", "--num-slots", "2",
                          "--cache-len", "128"], req)
    assert all(c["error_code"] == 0 for c in chunks), chunks
    model, mcfg = worker.load_idefics_model(ckpt, cfg, load_bit="int8",
                                            device="cpu")
    fn = worker.make_idefics_stream_fn(
        OtterGenerator(model, cache_dtype=torch.int8),
        AutoTokenizer.from_pretrained(tok_dir), mcfg)
    assert [c["text"] for c in chunks] == list(fn(req))
    assert chunks[-1]["text"]


def test_worker_entry_point_serves_an_idefics_checkpoint(tmp_path):
    """`python -m otter_tpu_torch.serve.worker --model-family idefics
    --device cpu --no-register --config cfg.json` from an HF-named
    checkpoint of the tiny idefics model and a tokenizer saved in the
    test, at `--load-bit int8 --cache-bit int8`: one request with an image
    gives the text of the same start-up run in this process."""
    from transformers import AutoTokenizer
    cfg, ckpt, cfg_path, tok_dir = _idefics_files(tmp_path)
    req = {"prompt": "w5 <image> w17 w99 w3", "images": [_png(32)],
           "generation_kwargs": {"max_new_tokens": 5}}
    chunks = _run_worker(["--model-family", "idefics", "--config", cfg_path,
                          "--checkpoint", ckpt, "--tokenizer", tok_dir,
                          "--load-bit", "int8", "--cache-bit", "int8"], req)
    assert all(c["error_code"] == 0 for c in chunks), chunks
    model, mcfg = worker.load_idefics_model(ckpt, cfg, load_bit="int8",
                                            device="cpu")
    fn = worker.make_idefics_stream_fn(
        OtterGenerator(model, cache_dtype=torch.int8),
        AutoTokenizer.from_pretrained(tok_dir), mcfg)
    assert [c["text"] for c in chunks] == list(fn(req))
    assert chunks[-1]["text"]


def test_worker_entry_point_serves_a_session_with_a_draft(tmp_path):
    """`python -m otter_tpu_torch.serve.worker --draft-checkpoint
    draft.bin --draft-config draft.json --draft-gamma 3 --session-cache 2`
    over an HF checkpoint of the tiny model and one of a 2-layer mosaic_gpt
    draft (qk_ln, a cross-attention block before every layer) made in the
    test, at `--load-bit int8 --cache-bit int8`: a 3-turn conversation
    under one session id gives the texts of the stateless worker on the
    same start-up run in this process."""
    from transformers import AutoTokenizer
    from otter_tpu_torch.config import OtterConfig, save_config
    from otter_tpu_torch.models.convert import port_to_hf, save_state_dict
    from otter_tpu_torch.tools.random_weights import RandomParams
    cfg = OtterConfig.tiny("mpt")
    cfg_d = cfg.replace(text=cfg.text.replace(
        arch="mosaic_gpt", qk_ln=True, num_hidden_layers=2),
        cross_attn_every_n_layers=1)
    paths = {}
    for name, c, seed in (("target", cfg, 3), ("draft", cfg_d, 4)):
        paths[name] = str(tmp_path / f"{name}.bin")
        save_state_dict(port_to_hf(RandomParams(c, "cpu", seed=seed), c),
                        paths[name])
        save_config(c, str(tmp_path / f"{name}.json"))
    tok_dir = _tokenizer_dir(tmp_path / "tok", cfg)
    reqs = [{"prompt": "<image> w5 w17 w99 w3 w40 w41 w42 w43 w44 w45 w46 "
                       "w47 w48 w49 w50 w51 w52", "images": [_png(35)],
             "session_id": "chat", "generation_kwargs": {"max_new_tokens": 5}}]
    model, mcfg = worker.load_otter_model(paths["target"], cfg,
                                          load_bit="int8", device="cpu")
    plain = make_otter_stream_fn(OtterGenerator(model, cache_dtype=torch.int8),
                                 AutoTokenizer.from_pretrained(tok_dir), mcfg)
    want = []
    for t in range(3):
        want.append([c for c in plain(reqs[-1])])
        reqs.append(dict(reqs[-1], prompt=reqs[-1]["prompt"] + " "
                         + want[-1][-1] + f" <|endofchunk|> w{60 + t} w61"))
    got = _run_worker(["--config", str(tmp_path / "target.json"),
                       "--checkpoint", paths["target"], "--tokenizer",
                       tok_dir, "--load-bit", "int8", "--cache-bit", "int8",
                       "--draft-checkpoint", paths["draft"],
                       "--draft-config", str(tmp_path / "draft.json"),
                       "--draft-gamma", "3", "--session-cache", "2"],
                      reqs[:3])
    for chunks, texts in zip(got, want):
        assert all(c["error_code"] == 0 for c in chunks), chunks
        assert [c["text"] for c in chunks] == texts and texts[-1]
