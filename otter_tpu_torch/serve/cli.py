"""Terminal chat (counterpart of `otter_tpu/serve/cli.py`, the reference's
`pipeline/serve/cli.py`): interactive prompt -> the port's
`OtterGenerator.stream_generate` with streaming token printing.

    python -m otter_tpu_torch.serve.cli --checkpoint DIR --tokenizer DIR
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def chat_loop(engine, tokenizer, vision_x, gen, *, with_image: bool,
              input_fn=input, out=None):
    """Interactive REPL: read a question, render the inference prompt,
    stream-decode tokens, print incremental text (the reference's
    `generate_stream` printing contract, cli.py:14-70). Factored out of
    main() so tests can drive it through StringIO. Sampled turns draw
    from a generator seeded alike every turn."""
    from otter_tpu_torch.data.templates import inference_prompt
    from otter_tpu_torch.serve.worker import _generator

    out = out or sys.stdout
    out.write("Otter-TPU CLI chat. Ctrl-D to exit.\n")
    while True:
        try:
            question = input_fn("User: ")
        except EOFError:
            break
        prompt = inference_prompt(question, insert_image=with_image)
        ids = np.asarray(
            tokenizer(prompt, return_tensors="np")["input_ids"], np.int64)
        out.write("GPT: ")
        out.flush()
        pending = []
        for tok in engine.stream_generate(
                vision_x, ids, gen=gen,
                generator=_generator(gen, engine.device)):
            pending.append(int(tok))
            text = tokenizer.decode(pending, skip_special_tokens=True)
            prev = tokenizer.decode(pending[:-1], skip_special_tokens=True)
            out.write(text[len(prev):])
            out.flush()
        out.write("\n")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--config", default="mpt7b",
                   help="mpt7b, mpt1b, llama7b-video or another preset, or "
                        "a config JSON (config.save_config)")
    p.add_argument("--image", default=None, help="image file to condition on")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="the GPU by default; raises without one unless "
                        "another device (cpu) is named")
    args = p.parse_args(argv)

    from transformers import AutoTokenizer
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.data.mimicit import preprocess_image
    from otter_tpu_torch.device import resolve_device
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.serve.worker import _load_config, load_otter_model

    device = resolve_device(args.device)
    cfg = _load_config(args.config, "otter")
    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    model, cfg = load_otter_model(args.checkpoint, cfg, device=device)
    engine = OtterGenerator(model)

    size = cfg.vision.image_size
    if args.image:
        from PIL import Image
        vision_x = preprocess_image(Image.open(args.image).convert("RGB"),
                                    size)[None, None, None]
    else:
        vision_x = np.zeros((1, 1, 1, 3, size, size), np.float32)

    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        do_sample=args.temperature > 0, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p)

    chat_loop(engine, tokenizer, vision_x, gen,
              with_image=args.image is not None)


if __name__ == "__main__":
    main()
