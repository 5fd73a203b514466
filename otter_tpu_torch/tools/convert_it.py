"""Convert-it: pack image sources into MIMIC-IT image stores.

Rebuild of `mimic-it/convert-it/` (main.py:9-49, abstract_dataset.py:17-131,
image_utils.py:12-67) + `pipeline/utils/convert_to_parquet.py`: image
folders / frame dirs -> {image_id: base64} JSON (resized to 224 by
default), and JSON -> parquet with the `index -> base64 column` layout the
MimicitDataset reads.
"""

from __future__ import annotations

import base64
import io
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Tuple


def image_to_base64(path: str, resize_res: int = 224) -> str:
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if resize_res > 0:
        img = img.resize((resize_res, resize_res), Image.BICUBIC)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.urlsafe_b64encode(buf.getvalue()).decode()


def pack_image_folder(folder: str, *, prefix: str = "IMG",
                      resize_res: int = 224, num_threads: int = 16,
                      extensions=(".jpg", ".jpeg", ".png", ".webp")
                      ) -> Dict[str, str]:
    """folder of images -> {f"{prefix}_{stem}": base64}."""
    paths = sorted(
        os.path.join(folder, f) for f in os.listdir(folder)
        if f.lower().endswith(extensions))

    def one(p):
        stem = os.path.splitext(os.path.basename(p))[0]
        try:
            return f"{prefix}_{stem}", image_to_base64(p, resize_res)
        except Exception as e:
            print(f"skipping {p}: {e}")
            return None

    out = {}
    with ThreadPoolExecutor(num_threads) as pool:
        for item in pool.map(one, paths):
            if item:
                out[item[0]] = item[1]
    return out


def pack_video_frames(video_dirs: Iterable[Tuple[str, str]],
                      *, resize_res: int = 224) -> Dict[str, str]:
    """[(video_id, frames_dir)] -> {f"{video_id}_{frame_idx:08d}": b64}."""
    out = {}
    for vid, folder in video_dirs:
        frames = sorted(os.listdir(folder))
        for i, f in enumerate(frames):
            try:
                out[f"{vid}_{i:08d}"] = image_to_base64(
                    os.path.join(folder, f), resize_res)
            except Exception as e:
                print(f"skipping {f}: {e}")
    return out


def save_json(images: Dict[str, str], path: str) -> str:
    with open(path, "w") as f:
        json.dump(images, f)
    return path


def convert_json_to_parquet(input_path: str, output_path: str) -> str:
    """{id: base64} JSON -> parquet with index + 'base64' column
    (convert_to_parquet.py:86-88 layout)."""
    import pandas as pd
    with open(input_path, "rb") as f:
        data = json.loads(f.read())
    data = {k: (v[0] if isinstance(v, list) else v) for k, v in data.items()}
    df = pd.DataFrame.from_dict(data, orient="index", columns=["base64"])
    df.to_parquet(output_path, engine="pyarrow")
    return output_path


def main():
    import argparse
    p = argparse.ArgumentParser("convert-it")
    p.add_argument("--name", default=None,
                   help="per-source adapter (reference --name), e.g. "
                        "2d.Llava; omit to pack a plain image folder")
    p.add_argument("--image_path", default=None,
                   help="adapter annotations/source file (reference flag)")
    p.add_argument("--image_root", default=None,
                   help="adapter image root (reference flag)")
    p.add_argument("--num_threads", type=int, default=8)
    p.add_argument("--image_folder", help="folder of images to pack "
                                          "(generic mode)")
    p.add_argument("--output_json", required=True)
    p.add_argument("--output_parquet", default=None)
    p.add_argument("--prefix", default="IMG")
    p.add_argument("--resize_res", type=int, default=224)
    args = p.parse_args()
    if args.name:
        from otter_tpu_torch.tools.convert_it_datasets import DATASET_REGISTRY
        kwargs = {"num_threads": args.num_threads,
                  "resize_res": args.resize_res}
        if args.image_path is not None:
            kwargs["image_path"] = args.image_path
        if args.image_root is not None:
            kwargs["image_root"] = args.image_root
        images = DATASET_REGISTRY[args.name](**kwargs).load()
    else:
        images = pack_image_folder(args.image_folder, prefix=args.prefix,
                                   resize_res=args.resize_res)
    save_json(images, args.output_json)
    if args.output_parquet:
        convert_json_to_parquet(args.output_json, args.output_parquet)


if __name__ == "__main__":
    main()
