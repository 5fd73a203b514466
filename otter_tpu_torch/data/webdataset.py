"""Streaming tar-shard pretraining pipelines (counterpart of
`otter_tpu/data/webdataset.py`, the reference's webdataset pipelines,
`pipeline/mimicit_utils/data.py:158-632`) for LAION-2B / MMC4 / CC3M:

  - brace-expanded shard lists, deterministic epoch-seeded shard shuffle
    (`detshuffle2`, data.py:186) or with-replacement resampling
    (`ResampledShards2`, :218)
  - per-process and per-worker shard splits (`split_by_node`,
    `split_by_worker`)
  - error-tolerant tar iteration (`tarfile_to_samples_nothrow`, :158-163)
    and decode (`log_and_continue`, :122-127)
  - MMC4 interleaved preprocessing (`preprocess_interleaved`, :300-367):
    images over 10 KB, similarity threshold, at most 5 images padded to 5,
    <|endofchunk|> / <image> insertion, 50% single-image drop
  - LAION / CC3M pair preprocessing (`preprocess_laion_image/text`,
    :270-292)

Outputs numpy batches shaped for the Flamingo pretraining step: images
[B, T, 1, 3, 224, 224], input_ids / attention_mask [B, L].

Images decode through the C++ batch decoder (`otter_tpu_torch/native`,
OpenMP across a batch, libjpeg's scaled DCT decode) or through PIL
(`data.mimicit.preprocess_image`): `native="auto"` takes the C++ decoder
where it builds and PIL where it does not, `native=True` raises where it
cannot be had, `native=False` takes PIL. With the C++ decoder a LAION /
CC3M sample carries its encoded bytes to the batch, which decodes at once;
rows the decoder rejects (a non-zero status) decode through PIL.

The parallel shard reader's threads hand an exception that escapes the
handler to the consumer, which raises it; the JAX reader's thread ends
with it and the epoch comes up short with no error. The dataset
constructors take `args.patch_image_size` (224 where `args` has none);
the JAX ones take 224 whatever the flag says. They read every shard of
the rank with `args.workers` reader threads; the JAX ones hand `workers`
to the pipeline as its worker count, and the one process that iterates
it reads only the shards of worker 0 (one in `workers`).
"""

from __future__ import annotations

import base64
import io
import json
import math
import queue
import random
import re
import tarfile
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from otter_tpu_torch import native as native_lib
from otter_tpu_torch.data.mimicit import preprocess_image

MIN_KB = 10
MAX_NUM_IMAGES = 5


def log_and_continue(exn) -> bool:
    """Swallow decode errors, keep the stream alive (data.py:122-127)."""
    print(f"Handling webdataset error ({repr(exn)}). Ignoring.")
    return True


def braceexpand(pattern: str) -> List[str]:
    """Minimal {000..123} / {a,b,c} brace expansion."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if m:
        lo, hi = m.group(1), m.group(2)
        width = len(lo)
        out = []
        for i in range(int(lo), int(hi) + 1):
            out.extend(braceexpand(pattern[:m.start()] +
                                   str(i).zfill(width) + pattern[m.end():]))
        return out
    m = re.search(r"\{([^{}]*,[^{}]*)\}", pattern)
    if m:
        out = []
        for alt in m.group(1).split(","):
            out.extend(braceexpand(pattern[:m.start()] + alt +
                                   pattern[m.end():]))
        return out
    return [pattern]


def tar_samples(path: str, handler=log_and_continue) -> Iterator[dict]:
    """Iterate a tar shard, grouping members by key prefix
    ({"__key__": ..., ext: bytes})."""
    try:
        with tarfile.open(path, "r|*") as tf:
            current = None
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name
                if "/" in name:
                    name = name.rsplit("/", 1)[-1]
                if "." not in name:
                    continue
                key, ext = name.split(".", 1)
                data = tf.extractfile(member).read()
                if current is None or current["__key__"] != key:
                    if current is not None:
                        yield current
                    current = {"__key__": key}
                current[ext] = data
            if current is not None:
                yield current
    except Exception as e:
        if not handler(e):
            raise


class _ReaderFailed:
    def __init__(self, exc: BaseException):
        self.exc = exc


class ShardPipeline:
    """Composable shard -> sample -> batch pipeline."""

    def __init__(self, shards, preprocess, batch_size, *,
                 resampled: bool = False, seed: int = 0, epoch: int = 0,
                 rank: int = 0, world_size: int = 1, worker: int = 0,
                 num_workers: int = 1, shuffle_buffer: int = 1000,
                 num_parallel_shards: int = 4,
                 handler=log_and_continue):
        self.shards = list(shards)
        self.preprocess = preprocess
        self.batch_size = batch_size
        self.resampled = resampled
        self.seed = seed
        self.epoch = epoch
        self.rank = rank
        self.world_size = world_size
        self.worker = worker
        self.num_workers = num_workers
        self.shuffle_buffer = shuffle_buffer
        self.num_parallel_shards = num_parallel_shards
        self.handler = handler

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _shard_list(self) -> List[str]:
        # (a tuple of ints hashes the same in every process)
        rng = random.Random(hash((self.seed, self.epoch)))
        if self.resampled:
            # with-replacement resampling (ResampledShards2)
            return [rng.choice(self.shards) for _ in self.shards]
        shards = list(self.shards)
        rng.shuffle(shards)              # detshuffle2
        shards = shards[self.rank::self.world_size]
        return shards[self.worker::self.num_workers]

    def _raw_samples(self) -> Iterator:
        """Raw tar samples; shards read concurrently by reader threads
        when num_parallel_shards > 1 (tar IO and image decode release the
        GIL). A reader's failure is raised here."""
        shards = self._shard_list()
        if self.num_parallel_shards <= 1 or len(shards) <= 1:
            for shard in shards:
                yield from tar_samples(shard, self.handler)
            return

        out: queue.Queue = queue.Queue(maxsize=4 * self.shuffle_buffer
                                       if self.shuffle_buffer else 256)
        shard_q: queue.Queue = queue.Queue()
        for s in shards:
            shard_q.put(s)
        n_threads = min(self.num_parallel_shards, len(shards))
        done = threading.Event()

        def put(item) -> bool:
            while not done.is_set():
                try:
                    out.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def reader():
            try:
                while not done.is_set():
                    try:
                        shard = shard_q.get_nowait()
                    except queue.Empty:
                        return
                    for raw in tar_samples(shard, self.handler):
                        if not put(raw):
                            return
            except BaseException as e:   # to the consumer, not lost here
                put(_ReaderFailed(e))

        threads = [threading.Thread(target=reader, daemon=True)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        try:
            while any(t.is_alive() for t in threads) or not out.empty():
                try:
                    item = out.get(timeout=0.2)
                except queue.Empty:
                    continue
                if isinstance(item, _ReaderFailed):
                    raise item.exc
                yield item
        finally:
            done.set()

    def _samples(self) -> Iterator:
        rng = random.Random(hash((self.seed, self.epoch, self.rank,
                                  self.worker, 1)))
        buf: List = []
        for raw in self._raw_samples():
            try:
                item = self.preprocess(raw)
            except Exception as e:
                if not self.handler(e):
                    raise
                continue
            buf.append(item)
            if len(buf) >= self.shuffle_buffer:
                idx = rng.randrange(len(buf))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                yield buf.pop()
        rng.shuffle(buf)
        yield from buf

    def __iter__(self) -> Iterator[dict]:
        batch: List = []
        for item in self._samples():
            batch.append(item)
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []
        # partial=False: drop the trailing partial batch

    def _collate(self, batch: List[tuple]) -> dict:
        if isinstance(batch[0][0], (bytes, bytearray)):
            size = getattr(self.preprocess, "patch_size", 224)
            images = _native_decode([b[0] for b in batch], size)[:, None,
                                                                 None]
        else:
            images = np.stack([b[0] for b in batch])
        return {"images": images,
                "input_ids": np.stack([b[1] for b in batch]),
                "attention_mask": np.stack([b[2] for b in batch])}


# ── preprocessing fns ───────────────────────────────────────────────


def _decode(raw: bytes, size: int) -> np.ndarray:
    from PIL import Image
    return preprocess_image(Image.open(io.BytesIO(raw)).convert("RGB"), size)


def _native_decode(raws: List[bytes], size: int) -> np.ndarray:
    """[N, 3, S, S] f32 through the C++ batch decoder with its scaled DCT
    decode (the training pipelines opt in: a few LSBs off a full decode);
    the rows it rejects through PIL."""
    from otter_tpu_torch.data.templates import FLAMINGO_MEAN, FLAMINGO_STD
    out, status = native_lib.preprocess_batch(
        raws, size, FLAMINGO_MEAN, FLAMINGO_STD, scaled_decode=True)
    for i in np.nonzero(status)[0]:
        out[i] = _decode(raws[i], size)
    return out


def _encode_text(tokenizer, text: str, max_length: int):
    enc = tokenizer(text, add_special_tokens=False, truncation=True,
                    max_length=max_length)
    ids = np.full((max_length,), tokenizer.pad_token_id or 0, np.int32)
    mask = np.zeros((max_length,), np.int32)
    n = len(enc["input_ids"])
    ids[:n] = enc["input_ids"]
    mask[:n] = 1
    return ids, mask


def make_pair_preprocessor(tokenizer, *, patch_size: int = 224,
                           max_length: int = 32,
                           prompt_format: str = "simple",
                           native="auto"):
    """LAION / CC3M (image, caption) pairs (data.py:270-292): text becomes
    `<image>{caption}<|endofchunk|>`, images -> [1, 1, 3, H, W]. With
    the C++ decoder the image stays encoded until the batch collates."""
    use_native = native_lib.resolve(native)

    def fn(sample: dict):
        img_bytes = next((sample[k] for k in ("jpg", "jpeg", "png", "webp")
                          if k in sample), None)
        if img_bytes is None:
            raise ValueError("no image in sample")
        caption = sample.get("txt", b"").decode("utf-8").strip()
        if use_native:
            arr = bytes(img_bytes)        # decoded in ShardPipeline._collate
        else:
            arr = _decode(img_bytes, patch_size)[None, None].astype(
                np.float32)
        if prompt_format == "llama2_inst":
            text = (f"<image>[INST]please describe this image.[/INST]"
                    f"{caption}<|endofchunk|>")
        else:
            text = f"<image>{caption}<|endofchunk|>"
        ids, mask = _encode_text(tokenizer, text, max_length)
        return arr, ids, mask

    fn.patch_size = patch_size
    return fn


def make_interleaved_preprocessor(tokenizer, *, media_token_id: int,
                                  patch_size: int = 224,
                                  sim_threshold: float = 0.24,
                                  max_length: int = 256,
                                  single_image_drop: float = 0.5,
                                  rng: Optional[random.Random] = None,
                                  native="auto"):
    """MMC4 interleaved documents (preprocess_interleaved,
    data.py:300-367). With the C++ decoder a sample's images decode in
    one call."""
    use_native = native_lib.resolve(native)
    rng = rng or random.Random(0)

    def fn(sample: dict):
        info = json.loads(sample["json"])
        sentences = list(info["text_list"])
        raws, sentence_ixs = [], []
        for im in info["image_info"]:
            rawbytes = base64.b64decode(im["image_base64"])
            if len(rawbytes) // 1000 <= MIN_KB:
                continue
            if im["matched_sim"] < sim_threshold:
                continue
            raws.append(rawbytes)
            sentence_ixs.append(im["matched_text_index"])
        if use_native and raws:
            images = list(_native_decode(raws, patch_size))
        else:
            images = [_decode(r, patch_size) for r in raws]
        if not images:
            raise ValueError("No images in sample")
        images = images[:MAX_NUM_IMAGES]
        sentence_ixs = sentence_ixs[:MAX_NUM_IMAGES]
        stack = np.zeros((MAX_NUM_IMAGES, 1, 3, patch_size, patch_size),
                         np.float32)
        stack[:len(images), 0] = np.stack(images)

        for ix in sentence_ixs:
            sentences[ix] = f"<|endofchunk|><image>{sentences[ix]}"
        text = " ".join(sentences)
        text = text.replace("<|endofchunk|>", "", 1)
        text = text.replace(" <|endofchunk|>", "<|endofchunk|>")
        text = text.replace("<image> ", "<image>").replace(" <image>",
                                                           "<image>")
        text = f"{text}<|endofchunk|>"
        ids, mask = _encode_text(tokenizer, text, max_length)
        num_images = int((ids == media_token_id).sum())
        if num_images == 0:
            raise ValueError("No images in sample")
        if num_images == 1 and rng.random() <= single_image_drop:
            raise ValueError("Only one image in sample")
        return stack, ids, mask

    return fn


# ── public dataset constructors (get_data dispatch, data.py:716-730) ─


@dataclass
class DataInfo:
    dataloader: ShardPipeline
    num_batches: int
    num_samples: int


def _arith(num_samples: int, batch_size: int, world_size: int,
           floor: bool = False) -> tuple:
    round_fn = math.floor if floor else math.ceil
    global_batch = batch_size * world_size
    num_batches = round_fn(num_samples / global_batch)
    return num_batches, num_batches * global_batch


def _dataset(args, shards: str, preprocess, batch_size: int,
             num_samples: int, epoch: int, floor: bool) -> DataInfo:
    # one process reads all of its rank's shards, `args.workers` of them
    # at a time (the JAX constructors pass workers as `num_workers` to a
    # pipeline that one process iterates as worker 0, which then reads
    # one shard in `workers`)
    pipeline = ShardPipeline(
        braceexpand(shards), preprocess, batch_size,
        resampled=getattr(args, "dataset_resampled", False),
        seed=args.seed, epoch=epoch, rank=args.rank,
        world_size=args.world_size,
        num_parallel_shards=max(args.workers, 1))
    nb, ns = _arith(num_samples, batch_size, args.world_size, floor)
    return DataInfo(pipeline, nb, ns)


def _patch(args) -> int:
    # (the JAX constructors always take 224, whatever the flag says)
    return getattr(args, "patch_image_size", 224)


def get_laion_dataset(args, tokenizer, epoch: int = 0,
                      floor: bool = False) -> DataInfo:
    return _dataset(args, args.laion_shards, make_pair_preprocessor(
        tokenizer, patch_size=_patch(args)), args.batch_size_laion,
        args.train_num_samples_laion, epoch, floor)


def get_cc3m_dataset(args, tokenizer, epoch: int = 0,
                     floor: bool = False) -> DataInfo:
    return _dataset(args, args.cc3m_shards, make_pair_preprocessor(
        tokenizer, patch_size=_patch(args)), args.batch_size_cc3m,
        args.train_num_samples_cc3m, epoch, floor)


def get_mmc4_dataset(args, tokenizer, epoch: int = 0,
                     floor: bool = False) -> DataInfo:
    return _dataset(args, args.mmc4_shards, make_interleaved_preprocessor(
        tokenizer, media_token_id=args.media_token_id,
        patch_size=_patch(args),
        sim_threshold=args.mmc4_textsim_threshold), args.batch_size_mmc4,
        args.train_num_samples_mmc4, epoch, floor)


def get_data(args, tokenizer, dataset_type: str, epoch: int = 0) -> DataInfo:
    """Dispatch (data.py:716-730)."""
    if dataset_type == "laion":
        return get_laion_dataset(args, tokenizer, epoch)
    if dataset_type == "mmc4":
        return get_mmc4_dataset(args, tokenizer, epoch)
    if dataset_type == "cc3m":
        return get_cc3m_dataset(args, tokenizer, epoch)
    raise ValueError(f"unknown dataset_type {dataset_type!r}")
