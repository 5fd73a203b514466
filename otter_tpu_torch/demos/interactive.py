"""Interactive terminal demos (counterpart of
`otter_tpu/demos/interactive.py`, the reference's
`pipeline/demos/interactive/`):

  image      — single-image chat loop (otter_image.py:52-60 prompt
               contract; the basic loop also lives in serve/cli.py)
  incontext  — in-context chat: N (image, question, answer) context
               triples condition the query about a target image
               (otter_image_incontext.py)
  video      — cv2 uniform 16-frame extraction from a video file, then a
               chat loop over the frames (otter_video.py:29-44)

Usage:
  python -m otter_tpu_torch.demos.interactive image --checkpoint ... --image x.jpg
  python -m otter_tpu_torch.demos.interactive incontext --checkpoint ... \
      --context ctx1.jpg "what is this?" "an apple" --image query.jpg
  python -m otter_tpu_torch.demos.interactive video --checkpoint ... --video v.mp4
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np


def extract_frames(path: str, n_frames: int = 16) -> List:
    """Uniform frame sampling -> PIL images (reference otter_video.py:29-44
    `get_image`: cv2.VideoCapture + linspace over the frame count).
    Also accepts a DIRECTORY of image files (sorted) for environments
    without a video decoder."""
    from PIL import Image

    if os.path.isdir(path):
        files = sorted(
            f for f in os.listdir(path)
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
        if not files:
            raise ValueError(f"no image frames in directory {path}")
        idx = np.linspace(0, len(files) - 1, min(n_frames, len(files)),
                          dtype=int)
        return [Image.open(os.path.join(path, files[i])).convert("RGB")
                for i in idx]

    import cv2

    cap = cv2.VideoCapture(path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if total <= 0:
        raise ValueError(f"cannot read video {path}")
    idx = set(np.linspace(0, total - 1, min(n_frames, total), dtype=int)
              .tolist())
    frames = []
    for i in range(total):
        ok, frame = cap.read()
        if not ok:
            break
        if i in idx:
            frames.append(Image.fromarray(
                cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)))
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return frames


def _interactive_loop(ask, *, input_fn=input, out=None, banner: str):
    out = out or sys.stdout
    out.write(banner + "\n")
    while True:
        try:
            q = input_fn("User: ")
        except EOFError:
            break
        if not q.strip():
            continue
        out.write("GPT: " + ask(q.strip()) + "\n")
        out.flush()


def run_image(tester, image_path: str, **io):
    from PIL import Image
    img = Image.open(image_path).convert("RGB")
    _interactive_loop(lambda q: tester.ask(q, img),
                      banner="Otter image chat. Ctrl-D to exit.", **io)


def run_incontext(tester, image_path: str, context, **io):
    """context: [(image, question, answer), ...] triples (reference
    otter_image_incontext.py's two worked examples become CLI args)."""
    from PIL import Image
    img = Image.open(image_path).convert("RGB")
    ctx = [(Image.open(p).convert("RGB"), q, a) for p, q, a in context]

    def ask(q):
        return tester.ask(q, img, in_context=ctx)

    _interactive_loop(
        ask, banner=f"Otter in-context chat ({len(ctx)} examples). "
                    "Ctrl-D to exit.", **io)


def run_video(tester, video_path: str, n_frames: int = 16, **io):
    frames = extract_frames(video_path, n_frames)
    _interactive_loop(
        lambda q: tester.ask(q, frames),
        banner=f"Otter video chat ({len(frames)} frames). Ctrl-D to exit.",
        **io)


def main(argv=None):
    p = argparse.ArgumentParser("interactive demos")
    p.add_argument("mode", choices=["image", "incontext", "video"])
    p.add_argument("--checkpoint", default="")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--config", default="mpt7b")
    p.add_argument("--image", default=None)
    p.add_argument("--video", default=None)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--context", nargs=3, action="append", default=[],
                   metavar=("IMG", "QUESTION", "ANSWER"),
                   help="in-context example triple; repeatable")
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--device", default=None,
                   help="the model's device (default: the GPU)")
    args = p.parse_args(argv)

    from otter_tpu_torch.demos.demo_models import TestOtter, TestOtterVideo

    cls = TestOtterVideo if args.mode == "video" else TestOtter
    tester = cls(checkpoint=args.checkpoint, config=args.config,
                 tokenizer=args.tokenizer,
                 max_new_tokens=args.max_new_tokens, device=args.device)
    if args.mode == "image":
        run_image(tester, args.image)
    elif args.mode == "incontext":
        run_incontext(tester, args.image, args.context)
    else:
        run_video(tester, args.video, args.frames)


if __name__ == "__main__":
    main()
