# A copy of otter_tpu/serve/test_message.py (the port imports nothing of the JAX package);
# tests/test_torch_serve.py holds its output equal to the original's.
"""Serving smoke test (reference `pipeline/serve/test_message.py`): send a
prompt through the controller → worker HTTP path and print the streamed
chunks."""

from __future__ import annotations

import argparse
import json


def main():
    import requests
    p = argparse.ArgumentParser()
    p.add_argument("--controller-address", default="http://localhost:21001")
    p.add_argument("--model-name", default="otter")
    p.add_argument("--message", default="What is in this image?")
    p.add_argument("--max-new-tokens", type=int, default=32)
    args = p.parse_args()

    r = requests.post(args.controller_address + "/list_models", timeout=10)
    models = r.json()["models"]
    print(f"models: {models}")

    r = requests.post(args.controller_address + "/get_worker_address",
                      json={"model": args.model_name}, timeout=10)
    addr = r.json()["address"]
    print(f"worker: {addr}")

    prompt = f"<image>User: {args.message} GPT:<answer>"
    r = requests.post(addr + "/worker_generate_stream", json={
        "model": args.model_name, "prompt": prompt, "images": [],
        "generation_kwargs": {"max_new_tokens": args.max_new_tokens}},
        stream=True, timeout=120)
    for chunk in r.iter_lines(decode_unicode=False, delimiter=b"\0"):
        if chunk:
            print(json.loads(chunk)["text"])


if __name__ == "__main__":
    main()
