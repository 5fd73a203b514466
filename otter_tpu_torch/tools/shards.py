"""Pretraining shard preparation (torch/webdataset-free).

Rebuilds `pipeline/utils/convert_mmc4_to_wds.py`,
`convert_laion400m-tsv_to_laion400m-tar_mp_shard.py` and
`make_a_train.py`: source archives/TSVs -> the tar shard layout consumed
by `otter_tpu_torch/data/webdataset.py` (members named `{key}.{ext}`; MMC4
samples are a single `{key}.json` with `image_info[].image_base64`,
LAION/CC3M pairs are `{key}.png`/`{key}.jpg` + `{key}.txt`).
"""

from __future__ import annotations

import base64
import io
import json
import os
import tarfile
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Optional


class ShardWriter:
    """Rolls tar shards `{output_dir}/{%09d}.tar` at maxcount samples or
    maxsize bytes (the wds.ShardWriter contract the reference tools use,
    convert_mmc4_to_wds.py:35)."""

    def __init__(self, output_dir: str, *, maxcount: int = 30000,
                 maxsize: float = 1e10, start_shard: int = 0):
        os.makedirs(output_dir, exist_ok=True)
        self.dir = output_dir
        self.maxcount = maxcount
        self.maxsize = maxsize
        self.shard = start_shard
        self.count = 0
        self.size = 0
        self._tar: Optional[tarfile.TarFile] = None
        self.shards_written = []

    def _open(self):
        path = os.path.join(self.dir, f"{self.shard:09d}.tar")
        self._tar = tarfile.open(path, "w")
        self.shards_written.append(path)
        self.shard += 1
        self.count = 0
        self.size = 0

    def write(self, sample: Dict):
        """sample: {"__key__": str, ext: bytes|str|json-able}."""
        if self._tar is None or self.count >= self.maxcount \
                or self.size >= self.maxsize:
            self.close()
            self._open()
        key = sample["__key__"]
        for ext, val in sample.items():
            if ext == "__key__":
                continue
            if isinstance(val, bytes):
                data = val
            elif isinstance(val, str):
                data = val.encode("utf-8", "replace")
            else:
                data = json.dumps(val).encode()
            info = tarfile.TarInfo(f"{key}.{ext}")
            info.size = len(data)
            self._tar.addfile(info, io.BytesIO(data))
            self.size += len(data)
        self.count += 1

    def close(self):
        if self._tar is not None:
            self._tar.close()
            self._tar = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def convert_mmc4_to_wds(image_shards: Iterable[str],
                        doc_shards: Iterable[str], output_dir: str, *,
                        maxcount: int = 30000) -> int:
    """MMC4 distribution (per-shard images tar + docs jsonl) -> wds tars
    whose `json` member embeds each image as base64 under
    `image_info[].image_base64` (the layout `preprocess_interleaved`
    consumes; reference convert_mmc4_to_wds.py:28-70). Returns the
    number of samples written."""
    from otter_tpu_torch.data.webdataset import braceexpand

    image_shards = [p for pat in image_shards
                    for p in braceexpand(pat)]
    doc_shards = [p for pat in doc_shards for p in braceexpand(pat)]
    assert len(doc_shards) == len(image_shards), \
        "each doc shard needs a matching image shard"
    written = 0
    with ShardWriter(output_dir, maxcount=maxcount) as sink:
        for img_path, doc_path in zip(image_shards, doc_shards):
            try:
                tar = tarfile.open(img_path)
            except Exception as e:
                print(f"skip {img_path}: {e}")
                continue
            try:
                by_name = {}
                for m in tar.getmembers():
                    if m.isfile():
                        base = m.name.rsplit("/", 1)[-1]
                        by_name[base] = m
                with open(doc_path) as jf:
                    for line in jf:
                        doc = json.loads(line)
                        ok = True
                        for info in doc.get("image_info", []):
                            m = by_name.get(info["image_name"])
                            if m is None:
                                ok = False
                                break
                            raw = tar.extractfile(m).read()
                            info["image_base64"] = base64.b64encode(
                                raw).decode()
                        if not ok:
                            continue
                        sink.write({"__key__": uuid.uuid4().hex,
                                    "json": doc})
                        written += 1
            except Exception as e:
                print(f"skip {doc_path}: {e}")
            finally:
                tar.close()
    return written


def _read_tsv_pairs(image_tsv: str, text_tsv: str):
    """LAION-400M TSV distribution: image rows `name\\tbase64`, caption
    rows `name\\t{"captions": [...]}` (reference TSVFile usage,
    convert_laion...py:178-202)."""
    with open(image_tsv) as fi, open(text_tsv) as ft:
        for img_line, txt_line in zip(fi, ft):
            iname, ib64 = img_line.rstrip("\n").split("\t", 1)
            tname, tjson = txt_line.rstrip("\n").split("\t", 1)
            assert iname == tname, f"row mismatch {iname} != {tname}"
            try:
                caption = json.loads(tjson)["captions"][0]
            except Exception:
                continue
            if caption is None:
                continue
            yield base64.b64decode(ib64), caption


def convert_laion_tsv_to_wds(tsv_root: str, output_dir: str, *,
                             maxcount: int = 30000,
                             num_threads: int = 4) -> int:
    """Every `*image*.tsv` in tsv_root (paired with its `*text*.tsv`)
    -> wds tars of {png, txt} samples. Threaded across TSV files like
    the reference's ThreadPoolExecutor fan-out."""
    tsv_ids = sorted(f for f in os.listdir(tsv_root)
                     if "tsv" in f and "image" in f)
    written = 0
    with ShardWriter(output_dir, maxcount=maxcount) as sink:
        def load(tsv_id):
            return list(_read_tsv_pairs(
                os.path.join(tsv_root, tsv_id),
                os.path.join(tsv_root, tsv_id.replace("image", "text"))))

        with ThreadPoolExecutor(num_threads) as pool:
            for pairs in pool.map(load, tsv_ids):
                for png, caption in pairs:
                    sink.write({"__key__": uuid.uuid4().hex,
                                "png": png, "txt": caption})
                    written += 1
    return written


def make_a_train(input_file: str, output_file: str, *,
                 remove_rel_ins_ids: bool = False) -> Dict:
    """Instruction JSON -> {id: [valid rel_ins_ids]} "train" map, each
    rel_ins appearing under one anchor only (reference make_a_train.py:
    the dedup set ensures an in-context example is not also a primary
    sample)."""
    with open(input_file) as f:
        data = json.load(f)["data"]
    seen = set()
    out = {}
    for key, value in data.items():
        if key in seen:
            continue
        if remove_rel_ins_ids:
            valid = []
        else:
            valid = [r for r in value.get("rel_ins_ids", [])
                     if r in data]
        out[key] = valid
        seen.update(valid)
    with open(output_file, "w") as f:
        json.dump(out, f)
    return out


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser("shard prep")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("mmc4", help="MMC4 image tars + doc jsonls -> wds")
    m.add_argument("--image_shards", required=True,
                   help="brace pattern, e.g. shard_{0..9}_images_v2.tar")
    m.add_argument("--doc_shards", required=True)
    m.add_argument("--output_dir", required=True)
    m.add_argument("--maxcount", type=int, default=30000)

    l = sub.add_parser("laion-tsv", help="LAION TSV root -> wds")
    l.add_argument("--tsv_root", required=True)
    l.add_argument("--output_dir", required=True)
    l.add_argument("--maxcount", type=int, default=30000)
    l.add_argument("--num_threads", type=int, default=4)

    t = sub.add_parser("make-a-train", help="rel_ins train map")
    t.add_argument("--input_file", required=True)
    t.add_argument("--output_file", required=True)
    t.add_argument("--remove_rel_ins_ids", action="store_true")

    args = p.parse_args(argv)
    if args.cmd == "mmc4":
        n = convert_mmc4_to_wds([args.image_shards], [args.doc_shards],
                                args.output_dir, maxcount=args.maxcount)
        print(f"wrote {n} samples to {args.output_dir}")
    elif args.cmd == "laion-tsv":
        n = convert_laion_tsv_to_wds(args.tsv_root, args.output_dir,
                                     maxcount=args.maxcount,
                                     num_threads=args.num_threads)
        print(f"wrote {n} samples to {args.output_dir}")
    else:
        out = make_a_train(args.input_file, args.output_file,
                           remove_rel_ins_ids=args.remove_rel_ins_ids)
        print(f"wrote {len(out)} train keys to {args.output_file}")


if __name__ == "__main__":
    main()
