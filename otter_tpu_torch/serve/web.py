# A copy of otter_tpu/serve/web.py (the port imports nothing of the JAX package);
# tests/test_torch_serve.py holds its output equal to the original's.
"""Web chat UI (image + video) — the reference's Gradio servers
(`pipeline/serve/gradio_web_server.py`, `gradio_web_server_video.py`)
rebuilt as a dependency-free aiohttp app (Gradio is not available in this
image). Feature parity with the Gradio UX where it matters:

  - multi-turn conversation state, rendered server-side through the family
    prompt templates (serve/conversation.py `render_prompt`)
  - model selector fed by the controller's /list_models (+ refresh)
  - generation parameter controls: temperature, top_p, max_new_tokens,
    num_beams, no_repeat_ngram_size (gradio_web_server.py:361-370)
  - regenerate / clear-history (gradio_web_server.py:121-141)
  - vote logging (up/down/flag) and per-round conversation logs as JSONL
    (vote_last_response gradio_web_server.py:108-118; conv logs :46-49)
  - streaming consumption of the worker's `\\0`-delimited JSON protocol

Also provides the standalone deploy endpoint (POST /app/otter) mirroring
`pipeline/serve/deploy/otterhd_endpoint.py:62-98`.
"""

from __future__ import annotations

import datetime
import json
import os
import threading

INDEX_HTML = """<!doctype html>
<html><head><title>Otter-TPU Chat</title><style>
body{font-family:system-ui,sans-serif;max-width:860px;margin:1.5em auto;
     color:#222}
#log{border:1px solid #ccc;border-radius:8px;min-height:260px;padding:1em;
     margin-bottom:.7em}
.msg{margin:.4em 0;padding:.5em .8em;border-radius:8px;white-space:pre-wrap}
.you{background:#e8f1fd}.bot{background:#f4f4f4}
.msg b{display:block;font-size:.8em;color:#777;margin-bottom:.15em}
#controls{display:flex;flex-wrap:wrap;gap:.6em;align-items:center;
          font-size:.9em;margin:.5em 0}
#controls label{display:flex;flex-direction:column;font-size:.75em;
                color:#555}
#controls input{width:5em}
button{cursor:pointer;border:1px solid #bbb;background:#fafafa;
       border-radius:6px;padding:.35em .8em}
#sendrow{display:flex;gap:.5em}
#q{flex:1;padding:.45em}
#votes button{font-size:.85em}
#status{color:#888;font-size:.8em}
</style></head><body>
<h2>Otter-TPU Chat</h2>
<div id=controls>
 <label>model <select id=model></select></label>
 <button onclick=refreshModels()>&#x21bb; models</button>
 <label>template <select id=tpl>
   <option value=otter>otter</option>
   <option value=idefics>idefics</option></select></label>
 <label>temperature <input id=temp value=0.2></label>
 <label>top_p <input id=topp value=1.0></label>
 <label>max_new_tokens <input id=mnt value=512></label>
 <label>num_beams <input id=beams value=1></label>
 <label>no_repeat_ngram <input id=ngram value=0></label>
 <label><input type=checkbox id=vid style="width:auto"> video
   (files are frames)</label>
</div>
<div id=log></div>
<div id=sendrow>
 <input type=file id=img accept="image/*" multiple>
 <input id=q placeholder="Ask about the image..."
        onkeydown="if(event.key=='Enter')send()">
 <button onclick=send()>Send</button>
</div>
<p id=votes>
 <button onclick=vote('upvote')>&#128077;</button>
 <button onclick=vote('downvote')>&#128078;</button>
 <button onclick=vote('flag')>&#9873;</button>
 <button onclick=regenerate()>&#x21bb; Regenerate</button>
 <button onclick=clearHistory()>&#128465; Clear history</button>
 <span id=status></span>
</p>
<script>
let messages = [];   // [[user, assistant|null], ...]
let images = [];     // urlsafe-b64, fixed at first turn
let busy = false;
// per-conversation id: workers started with --session-cache reuse the
// turn's KV prefix instead of re-prefilling the whole history
let sessionId = crypto.randomUUID ? crypto.randomUUID()
                                  : String(Math.random()).slice(2);

async function refreshModels(){
  const r = await fetch('/list_models');
  const names = (await r.json()).models;
  const sel = document.getElementById('model');
  sel.innerHTML = '';
  for (const n of names){
    const o = document.createElement('option'); o.value = o.text = n;
    sel.appendChild(o);
  }
}
refreshModels();

async function readImages(){
  const files = document.getElementById('img').files;
  let out = [];
  for (const f of files){
    const b = await f.arrayBuffer();
    let s = btoa(String.fromCharCode(...new Uint8Array(b)));
    out.push(s.replace(/\\+/g,'-').replace(/\\//g,'_'));
  }
  if (document.getElementById('vid').checked && out.length)
    out = [out];
  return out;
}

function genKwargs(){
  const v = id => document.getElementById(id).value;
  return {max_new_tokens: parseInt(v('mnt')),
          temperature: parseFloat(v('temp')),
          top_p: parseFloat(v('topp')),
          num_beams: parseInt(v('beams')),
          no_repeat_ngram_size: parseInt(v('ngram')),
          do_sample: parseFloat(v('temp')) > 0};
}

async function send(){
  if (busy) return;
  const q = document.getElementById('q').value.trim();
  if (!q) return;
  document.getElementById('q').value = '';
  if (messages.length === 0) images = await readImages();
  messages.push([q, null]);
  render();
  await run();
}

async function regenerate(){
  if (busy || messages.length === 0) return;
  messages[messages.length-1][1] = null;
  render();
  await run();
}

function clearHistory(){
  if (busy) return;
  messages = []; images = [];
  sessionId = crypto.randomUUID ? crypto.randomUUID()
                                : String(Math.random()).slice(2);
  document.getElementById('img').value = '';
  render();
}

async function run(){
  busy = true;
  document.getElementById('status').textContent = 'generating...';
  const body = {model: document.getElementById('model').value || 'otter',
                template: document.getElementById('tpl').value,
                messages: messages, images: images,
                session_id: sessionId,
                generation_kwargs: genKwargs()};
  const resp = await fetch('/http_bot', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify(body)});
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  let buf = '';
  while (true){
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream:true});
    const parts = buf.split('\\0');
    buf = parts.pop();
    for (const p of parts){ if (p) {
      const d = JSON.parse(p);
      messages[messages.length-1][1] =
        d.error_code ? '[error] ' + d.text : d.text;
      render();
    }}
  }
  busy = false;
  document.getElementById('status').textContent = '';
}

async function vote(kind){
  if (messages.length === 0) return;
  await fetch('/vote', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({type: kind,
      model: document.getElementById('model').value || 'otter',
      messages: messages})});
  document.getElementById('status').textContent = 'vote recorded';
}

function render(){
  const d = document.getElementById('log');
  d.innerHTML = '';
  for (const [q, a] of messages){
    for (const [who, text] of [['You', q], ['Assistant', a]]){
      if (text === null) continue;
      const s = document.createElement('div');
      s.className = 'msg ' + (who == 'You' ? 'you' : 'bot');
      const b = document.createElement('b'); b.textContent = who;
      const t = document.createElement('span'); t.textContent = text;
      s.appendChild(b); s.appendChild(t); d.appendChild(s);
    }
  }
  d.scrollTop = d.scrollHeight;
}
</script></body></html>"""


class _JsonlLogger:
    """Append-only JSONL logs (the reference's conv/vote logs,
    gradio_web_server.py:46-49,108-118)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._lock = threading.Lock()

    def write(self, name: str, record: dict):
        os.makedirs(self.log_dir, exist_ok=True)
        record = dict(record)
        record["tstamp"] = datetime.datetime.now().isoformat()
        day = datetime.date.today().isoformat()
        path = os.path.join(self.log_dir, f"{day}-{name}.jsonl")
        with self._lock:
            with open(path, "a") as f:
                f.write(json.dumps(record) + "\n")


def build_app(controller_addr: str = None, worker_addr: str = None,
              log_dir: str = "serve_logs", moderate: bool = False,
              moderation_fn=None):
    """If worker_addr is given, talk to it directly (deploy/deploy.py
    standalone mode); else resolve via the controller per request.
    moderate=True gates user text through the moderation check before
    generation (reference --moderate, gradio_web_server.py:229-242)."""
    import requests
    from aiohttp import web

    from otter_tpu_torch.serve.conversation import render_prompt
    from otter_tpu_torch.serve.moderation import (MODERATION_MSG,
                                            violates_moderation)

    check_moderation = moderation_fn or violates_moderation
    logger = _JsonlLogger(log_dir)

    def resolve_worker(model: str) -> str:
        if worker_addr:
            return worker_addr
        r = requests.post(controller_addr + "/get_worker_address",
                          json={"model": model}, timeout=10)
        return r.json()["address"]

    async def index(request):
        return web.Response(text=INDEX_HTML, content_type="text/html")

    async def list_models(request):
        if worker_addr:
            return web.json_response({"models": ["otter"]})
        try:
            r = requests.post(controller_addr + "/list_models", timeout=10)
            return web.json_response({"models": r.json()["models"]})
        except Exception:
            return web.json_response({"models": []})

    async def vote(request):
        params = await request.json()
        logger.write("votes", {"type": params.get("type", "upvote"),
                               "model": params.get("model", ""),
                               "messages": params.get("messages", [])})
        return web.json_response({"ok": True})

    async def http_bot(request):
        import asyncio
        params = await request.json()
        # multi-turn UI sends `messages`; raw `prompt` kept for API users
        if "prompt" not in params and "messages" in params:
            params = dict(params)
            params["prompt"] = render_prompt(
                params.get("template", "otter"), params["messages"],
                with_image=bool(params.get("images")))
        resp = web.StreamResponse()
        await resp.prepare(request)
        if moderate:
            last_user = (params["messages"][-1][0]
                         if params.get("messages")
                         else params.get("prompt", ""))
            loop0 = asyncio.get_event_loop()
            flagged = await loop0.run_in_executor(
                None, lambda: check_moderation(last_user))
            if flagged:
                logger.write("moderation", {"text": last_user})
                await resp.write(json.dumps(
                    {"text": MODERATION_MSG, "error_code": 3}
                ).encode() + b"\0")
                return resp
        try:
            addr = resolve_worker(params.get("model", "otter"))
        except Exception:
            addr = ""
        if not addr:
            await resp.write(json.dumps(
                {"text": "no worker available", "error_code": 2}
            ).encode() + b"\0")
            return resp
        loop = asyncio.get_event_loop()
        # stream chunk-by-chunk in a thread to keep the event loop free
        r = await loop.run_in_executor(None, lambda: requests.post(
            addr + "/worker_generate_stream", json=params, stream=True,
            timeout=600))
        it = r.iter_lines(decode_unicode=False, delimiter=b"\0")

        def next_chunk():
            for c in it:
                if c:
                    return c
            return None

        final = {}
        while True:
            chunk = await loop.run_in_executor(None, next_chunk)
            if chunk is None:
                break
            try:
                final = json.loads(chunk)
            except Exception:
                pass
            await resp.write(chunk + b"\0")
        logger.write("conv", {"model": params.get("model", ""),
                              "prompt": params.get("prompt", ""),
                              "n_images": len(params.get("images") or []),
                              "response": final.get("text", ""),
                              "error_code": final.get("error_code", 0)})
        return resp

    async def app_otter(request):
        """Deploy endpoint parity (otterhd_endpoint.py:62-98): one-shot JSON
        {prompt, images} -> {result: final_text}."""
        params = await request.json()
        addr = resolve_worker(params.get("model", "otter"))
        final = {"text": "", "error_code": 2}
        if addr:
            r = requests.post(addr + "/worker_generate_stream", json=params,
                              timeout=600, stream=True)
            for chunk in r.iter_lines(decode_unicode=False, delimiter=b"\0"):
                if chunk:
                    final = json.loads(chunk)
        return web.json_response({"result": final["text"],
                                  "error_code": final.get("error_code", 0)})

    app = web.Application(client_max_size=64 * 1024 * 1024)
    app.router.add_get("/", index)
    app.router.add_get("/list_models", list_models)
    app.router.add_post("/vote", vote)
    app.router.add_post("/http_bot", http_bot)
    app.router.add_post("/app/otter", app_otter)
    return app


def main():
    import argparse
    from aiohttp import web
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--controller-address", default="http://localhost:21001")
    p.add_argument("--worker-address", default=None,
                   help="bypass the controller (standalone deploy mode)")
    p.add_argument("--log-dir", default="serve_logs",
                   help="JSONL conversation/vote logs directory")
    p.add_argument("--moderate", action="store_true",
                   help="gate user text through the moderation API")
    args = p.parse_args()
    web.run_app(build_app(args.controller_address, args.worker_address,
                          log_dir=args.log_dir, moderate=args.moderate),
                host=args.host, port=args.port)


if __name__ == "__main__":
    main()
