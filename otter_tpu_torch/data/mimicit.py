"""MIMIC-IT dataset: instruction JSON + parquet images -> training examples
(counterpart of `otter_tpu/data/mimicit.py`, the reference's
`pipeline/mimicit_utils/mimicit_dataset.py:99-593`), preserving the public
data format (docs/mimicit_format.md):

  - instruction JSON: {"data": {id: {instruction, answer, image_ids,
    rel_ins_ids}}}
  - images: parquet or JSON of {image_id: base64} (urlsafe base64)
  - train_config JSON: {id: [in-context ids]} (falls back to rel_ins_ids
    with populate_rel_ins, else no in-context examples)
  - task groups: IMAGE_TEXT / TEXT_ONLY / VIDEO_TEXT / IMAGE_TEXT_IN_CONTEXT
  - video: uniform frame resampling to `resample_frames`
  - images: bicubic resize to patch_image_size², CLIP-mean normalize

Output arrays are numpy (the train step moves them to the device). The
image store keeps plain {id: base64} dicts where the JAX module builds
pandas frames. A sample's images decode in one call of the C++ batch
decoder (`otter_tpu_torch/native`, scaled DCT decode) where `native`
allows it ("auto": where the library builds; True: always, raising where
it cannot be had), and through PIL otherwise or where the decoder rejects
an image (a non-zero status: the whole sample then decodes through PIL).
Any other error of the decoder propagates; the JAX module swallows every
exception and takes PIL. PIL and pyarrow are imported where they are
used.
"""

from __future__ import annotations

import base64
import io
import json
import os
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from otter_tpu_torch import native as native_lib
from otter_tpu_torch.data import templates

TASK_GROUPS = ("IMAGE_TEXT", "TEXT_ONLY", "VIDEO_TEXT",
               "IMAGE_TEXT_IN_CONTEXT")


def resample_frames(image_ids: Sequence[str], n: int) -> List[str]:
    """Uniform frame resampling (`resample_frames_fn`,
    mimicit_dataset.py:307-311)."""
    idx = np.linspace(0, len(image_ids) - 1, n).astype(int)
    return [image_ids[i] for i in idx]


def resample_data(keys: List[str], num_samples: int) -> List[str]:
    """Replicate/subsample a task's ids to `num_samples` (0 = all)."""
    if not num_samples:
        return list(keys)
    if num_samples <= len(keys):
        return list(keys)[:num_samples]
    reps = -(-num_samples // len(keys))
    return (list(keys) * reps)[:num_samples]


def decode_base64_image(b64: str):
    """urlsafe base64 -> RGB PIL image, truncated files tolerated
    (mimicit_dataset.py:34-36)."""
    from PIL import Image, ImageFile
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    return Image.open(io.BytesIO(
        base64.urlsafe_b64decode(b64))).convert("RGB")


def preprocess_image(img, size: int, mean=templates.FLAMINGO_MEAN,
                     std=templates.FLAMINGO_STD) -> np.ndarray:
    """bicubic resize -> [0,1] -> normalize; returns CHW float32
    (`patch_resize_transform`, mimicit_dataset.py:134-143)."""
    from PIL import Image
    img = img.resize((size, size), Image.BICUBIC)
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return arr.transpose(2, 0, 1)


@dataclass
class MimicitTask:
    name: str
    mimicit_path: str
    images_path: str = ""
    train_config_path: str = ""
    num_samples: int = 0
    task_description: Any = ""


def _parquet_images(path: str) -> Dict[Any, str]:
    """{index: base64} of a parquet image pack, keyed as pandas would index
    it: by the stored index column, else by row number."""
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError(f"reading {path} needs pyarrow, which is not "
                          "installed; convert the pack to JSON "
                          "({image_id: base64})") from e
    table = pq.read_table(path)
    meta = table.schema.pandas_metadata or {}
    index = meta.get("index_columns") or []
    names = [c for c in index if isinstance(c, str)]
    if names:
        ids = table.column(names[0]).to_pylist()
    elif index and isinstance(index[0], dict) \
            and index[0].get("kind") == "range":
        r = index[0]
        ids = list(range(r["start"], r["stop"], r["step"]))
    else:
        ids = list(range(table.num_rows))
    columns = [c for c in table.column_names if c not in names]
    col = "base64" if "base64" in columns else columns[0]
    return dict(zip(ids, table.column(col).to_pylist()))


def _json_images(path: str) -> Dict[Any, str]:
    """{id: base64} of a JSON image pack: {id: b64} (convert-it output) or
    {id: {"base64": b64, ...}} (the first field without a "base64" one)."""
    with open(path, "rb") as f:
        raw = json.loads(f.read())
    return {k: (v if not isinstance(v, dict) else
                v["base64"] if "base64" in v else next(iter(v.values())))
            for k, v in raw.items()}


class ImageStore:
    """id -> base64 lookup over parquet/JSON image packs, loaded lazily and
    shared across tasks (mimicit_dataset.py:221-240); the first pack that
    holds an id answers."""

    def __init__(self):
        self._packs: Dict[str, Dict[Any, str]] = {}

    def load(self, path: str):
        if not path or path in self._packs:
            return
        if path.endswith(".parquet"):
            self._packs[path] = _parquet_images(path)
        elif path.endswith(".json"):
            self._packs[path] = _json_images(path)
        else:
            raise ValueError(f"unsupported images_path {path!r}")

    def get(self, image_id: str) -> str:
        for pack in self._packs.values():
            if image_id in pack:
                return pack[image_id]
        raise KeyError(image_id)


class MimicitDataset:
    def __init__(self, tasks: Sequence[MimicitTask], tokenizer, *,
                 task_group: str = "IMAGE_TEXT",
                 instruction_format: str = "simple",
                 max_seq_len: int = 2048,
                 patch_image_size: int = 224,
                 resample_frames_to: int = 32,
                 keep_symbols: bool = True,
                 populate_rel_ins: bool = False,
                 with_task_description: bool = False,
                 mean=templates.FLAMINGO_MEAN,
                 std=templates.FLAMINGO_STD,
                 device_preprocess: bool = False,
                 native="auto",
                 seed: int = 0):
        assert task_group in TASK_GROUPS, task_group
        self.tokenizer = tokenizer
        self.task_group = task_group
        self.instruction_format = instruction_format
        self.max_seq_len = max_seq_len
        self.patch_image_size = patch_image_size
        self.resample_frames_to = resample_frames_to
        self.keep_symbols = keep_symbols
        self.with_task_description = with_task_description
        self.mean, self.std = mean, std
        # host/device preprocessing split: the host decodes and resizes in
        # uint8 only; /255, mean/std and the CHW transpose run on the
        # device (the models take uint8 [T,F,H,W,3] through
        # ops/image_prep.normalize_u8)
        self.device_preprocess = device_preprocess
        self.native = not device_preprocess and native_lib.resolve(native)
        self.seed = seed
        self.epoch = 0

        self.dataset: Dict[str, dict] = {}
        self.train_config: Dict[str, list] = {}
        self.train_data_list: List[str] = []
        self.task_mapping: Dict[str, int] = {}
        self.task_descriptions: List[Any] = []
        self.images = ImageStore()

        for tid, task in enumerate(tasks):
            assert os.path.exists(task.mimicit_path), (
                f"mimicit_path {task.mimicit_path} not found")
            with open(task.mimicit_path, "rb") as f:
                data = json.loads(f.read())["data"]
            self.dataset.update(data)

            if task.train_config_path:
                with open(task.train_config_path, "rb") as f:
                    cfg = json.loads(f.read())
            elif populate_rel_ins:
                cfg = {k: v.get("rel_ins_ids", []) for k, v in data.items()}
            else:
                cfg = {k: [] for k in data}

            sampled = resample_data(list(cfg.keys()), task.num_samples)
            self.train_data_list.extend(sampled)
            self.train_config.update(cfg)
            self.task_mapping.update({k: tid for k in sampled})
            self.task_descriptions.append(task.task_description)
            self.images.load(task.images_path)

    def __len__(self):
        return len(self.train_data_list)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    # ── per-sample processing (mimicit_dataset.py:352-456) ──────────

    def _build_text(self, instruction_id: str,
                    in_context_ids: Sequence[str]) -> str:
        parts = []
        all_ids = list(in_context_ids) + [instruction_id]
        for idx, cur_id in enumerate(all_ids):
            ins = templates.pre_question(self.dataset[cur_id]["instruction"],
                                         self.keep_symbols)
            ans = templates.pre_answer(self.dataset[cur_id]["answer"],
                                       self.keep_symbols)
            if self.task_group == "IMAGE_TEXT_IN_CONTEXT":
                insert_image, text_only = True, False
            else:
                insert_image = idx == 0
                text_only = self.task_group == "TEXT_ONLY"
            parts.append(templates.format_pair(
                ins, ans, self.instruction_format,
                insert_image=insert_image, is_text_only=text_only))
        return "".join(parts).rstrip("\n")

    def _load_patch_images(self, image_ids: Sequence[str],
                           is_video: bool) -> np.ndarray:
        """-> [T, F, 3, H, W] float32 (T media slots, F frames), or
        [T, F, H, W, 3] uint8 with device_preprocess."""
        if is_video:
            image_ids = resample_frames(image_ids, self.resample_frames_to)
        stack = self._decode_batch([self.images.get(i) for i in image_ids])
        if is_video:
            return stack[None]                     # [1, F, ...]
        return stack[:, None]                      # [T, 1, ...]

    def _decode_batch(self, b64_list: Sequence[str]) -> np.ndarray:
        if self.device_preprocess:
            # host half only: decode + uint8 bicubic resize -> [N, H, W, 3]
            from PIL import Image
            size = (self.patch_image_size, self.patch_image_size)
            return np.stack([
                np.asarray(decode_base64_image(s).resize(
                    size, Image.BICUBIC), np.uint8)
                for s in b64_list], 0)
        if self.native:
            out, status = native_lib.preprocess_batch(
                [s.encode() if isinstance(s, str) else s for s in b64_list],
                self.patch_image_size, tuple(self.mean), tuple(self.std),
                is_base64=True, scaled_decode=True)   # training: opt-in
            if (status == 0).all():
                return out
        return np.stack([preprocess_image(
            decode_base64_image(s), self.patch_image_size, self.mean,
            self.std) for s in b64_list], 0)

    def __getitem__(self, index: int) -> dict:
        # a tuple of ints hashes alike in every process: the task
        # description a sample draws is the JAX dataset's
        rng = random.Random((self.seed, self.epoch, index).__hash__())
        cur_id = self.train_data_list[index]
        if cur_id not in self.dataset or \
                "instruction" not in self.dataset[cur_id]:
            raise KeyError(f"invalid sample id {cur_id}")
        in_context = self.train_config.get(cur_id, [])
        image_ids = self.dataset[cur_id].get("image_ids") or []

        text = self._build_text(cur_id, in_context)
        desc = self.task_descriptions[self.task_mapping[cur_id]]
        if desc and self.with_task_description:
            if isinstance(desc, (list, tuple)):
                desc = rng.choice(list(desc))
            text = desc + "\n" + text

        if self.task_group == "TEXT_ONLY":
            s_px = self.patch_image_size
            patch_images = (np.zeros((1, 1, s_px, s_px, 3), np.uint8)
                            if self.device_preprocess
                            else np.zeros((1, 1, 3, s_px, s_px),
                                          np.float32))
        else:
            patch_images = self._load_patch_images(
                image_ids, is_video=(self.task_group == "VIDEO_TEXT"))

        enc = self.tokenizer(text, add_special_tokens=False, truncation=True,
                             max_length=self.max_seq_len)
        ids = [self.tokenizer.bos_token_id] + list(enc["input_ids"]) + \
            [self.tokenizer.eos_token_id]
        mask = [1] + list(enc["attention_mask"]) + [1]
        return {
            "id": cur_id,
            "input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(mask, np.int32),
            "patch_images": (patch_images if self.device_preprocess
                             else patch_images.astype(np.float32)),
            "task_group": self.task_group,
            "full_text": text,
        }

    # ── collation (collate_fn/collate_tokens, :510-593) ─────────────

    def collate(self, samples: Sequence[dict],
                pad_to_multiple: int = 1) -> dict:
        pad_id = self.tokenizer.pad_token_id
        if pad_id is None:
            pad_id = self.tokenizer.eos_token_id
        size = max(len(s["input_ids"]) for s in samples)
        if pad_to_multiple > 1:
            size = -(-size // pad_to_multiple) * pad_to_multiple
        b = len(samples)
        input_ids = np.full((b, size), pad_id, np.int32)
        mask = np.zeros((b, size), np.int32)
        for i, s in enumerate(samples):
            n = len(s["input_ids"])
            input_ids[i, :n] = s["input_ids"]
            mask[i, :n] = s["attention_mask"]

        t_max = max(s["patch_images"].shape[0] for s in samples)
        f_max = max(s["patch_images"].shape[1] for s in samples)
        img_dtype = samples[0]["patch_images"].dtype  # u8 = device prep
        images = np.zeros((b, t_max, f_max)
                          + samples[0]["patch_images"].shape[2:], img_dtype)
        for i, s in enumerate(samples):
            t, f = s["patch_images"].shape[:2]
            images[i, :t, :f] = s["patch_images"]

        return {
            "id": [s["id"] for s in samples],
            "task_group": [s["task_group"] for s in samples],
            "full_text": [s["full_text"] for s in samples],
            "net_input": {
                "input_ids": input_ids,
                "attention_masks": mask,
                "patch_images": images,
            },
        }


def mask_answer_labels(input_ids: np.ndarray, *, answer_token_id: int,
                       eoc_token_id: int, eos_token_id: int,
                       masking_number: int = -100) -> np.ndarray:
    """Label masking: -100 everywhere except eos positions and the spans
    (answer_idx+1 .. eoc_idx], position 0 always masked — vectorized port of
    `masking()` (instruction_following.py:163-192)."""
    b, s = input_ids.shape
    labels = np.where(input_ids == eos_token_id, input_ids, masking_number)
    is_ans = input_ids == answer_token_id
    is_eoc = input_ids == eoc_token_id
    # open[t] = an <answer> seen at < t with no <|endofchunk|> in between;
    # the eoc position itself is still labeled (span inclusive of eoc)
    for i in range(b):
        open_span = False
        for t in range(s):
            if open_span:
                labels[i, t] = input_ids[i, t]
            if is_ans[i, t]:
                open_span = True
            elif is_eoc[i, t]:
                open_span = False
    labels[:, 0] = masking_number
    return labels.astype(np.int32)


def find_and_remove_tokens(input_ids: np.ndarray, labels: np.ndarray,
                           attention_mask: np.ndarray, token_id: int,
                           pad_id: int) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """Remove all occurrences of token_id, left-shifting and right-padding
    (`find_and_remove_tokens`, train_utils.py:276-305)."""
    b, s = input_ids.shape
    out_ids = np.full_like(input_ids, pad_id)
    out_lab = np.full_like(labels, -100)
    out_mask = np.zeros_like(attention_mask)
    for i in range(b):
        keep = input_ids[i] != token_id
        n = int(keep.sum())
        out_ids[i, :n] = input_ids[i][keep]
        out_lab[i, :n] = labels[i][keep]
        out_mask[i, :n] = attention_mask[i][keep]
    return out_ids, out_lab, out_mask
