# A copy of otter_tpu/data/fuyu_processor.py (the port imports nothing of the JAX package);
# tests/test_torch_serve.py holds its output equal to the original's.
"""Fuyu/OtterHD processor: variable-resolution patching under static shapes.

Rebuild of the reference `FuyuProcessor`/`FuyuImageProcessor` path
(`fuyu/processing_fuyu.py:298-760`): images are scaled (never upscaled) to
fit a resolution, padded to patch multiples, cut into patch_size² patches,
and represented in the token stream as rows of `image_placeholder_id`
terminated by `image_newline_id`, followed by BOS + prompt (+ the \\x04
beginning-of-answer token). Labels unmask the span between the first and
second \\x04 (`get_labels`, :348-368); the last \\x04 is replaced by EOS
(`find_and_remove_tokens`, :324-346).

XLA static shapes (SURVEY.md hard part #4) come from **resolution buckets**:
each image is assigned the smallest bucket that contains it; patch counts
are therefore drawn from a finite set, and batches pad to the per-batch max
with dummy index -1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

# dynamic-resolution training choices of the reference
# (`prepare_fuyu`, mimicit_dataset.py:498-499) plus the native max
DEFAULT_BUCKETS = ((448, 448), (512, 512), (768, 768), (1080, 1920))


@dataclass
class FuyuImageProcessor:
    patch_size: int = 30
    buckets: Tuple[Tuple[int, int], ...] = DEFAULT_BUCKETS
    image_mean: float = 0.5
    image_std: float = 0.5

    def pick_bucket(self, h: int, w: int) -> Tuple[int, int]:
        for bh, bw in sorted(self.buckets, key=lambda b: b[0] * b[1]):
            if h <= bh and w <= bw:
                return bh, bw
        return sorted(self.buckets, key=lambda b: b[0] * b[1])[-1]

    def process(self, image, target_resolution: Optional[Tuple[int, int]]
                = None) -> dict:
        """PIL image -> {patches [n_patches, p*p*3] f32, n_rows, n_cols}.

        target_resolution forces an exact resize (dynamic-resolution
        training); otherwise downscale-to-fit the assigned bucket
        (never upscale), then zero-pad to patch multiples.
        """
        from PIL import Image
        p = self.patch_size
        if target_resolution is not None:
            image = image.resize((target_resolution[1],
                                  target_resolution[0]), Image.BILINEAR)
        w, h = image.size
        bh, bw = self.pick_bucket(h, w)
        scale = min(bh / h, bw / w, 1.0)
        if scale < 1.0:
            image = image.resize((max(int(w * scale), 1),
                                  max(int(h * scale), 1)), Image.BILINEAR)
            w, h = image.size
        ph = math.ceil(h / p) * p
        pw = math.ceil(w / p) * p
        arr = np.asarray(image.convert("RGB"), np.float32) / 255.0
        arr = (arr - self.image_mean) / self.image_std
        padded = np.zeros((ph, pw, 3), np.float32)
        padded[:h, :w] = arr
        n_rows, n_cols = ph // p, pw // p
        patches = padded.reshape(n_rows, p, n_cols, p, 3)
        patches = patches.transpose(0, 2, 1, 3, 4).reshape(
            n_rows * n_cols, p * p * 3)
        return {"patches": patches, "n_rows": n_rows, "n_cols": n_cols}


@dataclass
class FuyuProcessor:
    tokenizer: object
    image_processor: FuyuImageProcessor = field(
        default_factory=FuyuImageProcessor)
    image_placeholder_id: int = 71011
    image_newline_id: int = 71019
    boa_token: str = "\x04"
    max_position_embeddings: int = 16384
    max_tokens_to_generate: int = 10

    def boa_id(self) -> int:
        ids = self.tokenizer(self.boa_token,
                             add_special_tokens=False)["input_ids"]
        return ids[-1]

    def encode_sample(self, text: str, image=None,
                      target_resolution: Optional[Tuple[int, int]] = None,
                      add_bos: bool = True,
                      add_boa: bool = False) -> dict:
        """-> {input_ids [S], image_patches [P, pd], image_patches_indices
        [S]} (single sample; image tokens lead the stream as in
        construct_full_unpacked_stream)."""
        img_token_ids: List[int] = []
        img_token_idx: List[int] = []
        patches = np.zeros((0, self.image_processor.patch_size ** 2 * 3),
                           np.float32)
        if image is not None:
            enc = self.image_processor.process(image, target_resolution)
            patches = enc["patches"]
            k = 0
            for _ in range(enc["n_rows"]):
                for _ in range(enc["n_cols"]):
                    img_token_ids.append(self.image_placeholder_id)
                    img_token_idx.append(k)
                    k += 1
                img_token_ids.append(self.image_newline_id)
                img_token_idx.append(-1)

        text_ids = list(self.tokenizer(
            text, add_special_tokens=False,
            truncation=True,
            max_length=self.max_position_embeddings)["input_ids"])
        if add_bos and self.tokenizer.bos_token_id is not None:
            text_ids = [self.tokenizer.bos_token_id] + text_ids
        if add_boa:
            text_ids = text_ids + [self.boa_id()]

        input_ids = img_token_ids + text_ids
        indices = img_token_idx + [-1] * len(text_ids)
        return {
            "input_ids": np.asarray(input_ids, np.int32),
            "image_patches": patches,
            "image_patches_indices": np.asarray(indices, np.int32),
        }

    def __call__(self, text: Sequence[str], images=None,
                 target_resolution: Optional[Tuple[int, int]] = None,
                 left_pad: bool = False) -> dict:
        """Batch encode + pad (right-pad default for training,
        `_right_pad_inputs_with_attention_mask` :368-408; left for
        generation)."""
        images = images or [None] * len(text)
        samples = [self.encode_sample(t, im, target_resolution)
                   for t, im in zip(text, images)]
        pad_id = self.tokenizer.eos_token_id
        s_max = max(len(s["input_ids"]) for s in samples)
        p_max = max((s["image_patches"].shape[0] for s in samples),
                    default=0)
        b = len(samples)
        pd = self.image_processor.patch_size ** 2 * 3
        input_ids = np.full((b, s_max), pad_id, np.int32)
        indices = np.full((b, s_max), -1, np.int32)
        mask = np.zeros((b, s_max), np.int32)
        patch_arr = np.zeros((b, max(p_max, 1), pd), np.float32)
        for i, s in enumerate(samples):
            n = len(s["input_ids"])
            sl = slice(s_max - n, s_max) if left_pad else slice(0, n)
            input_ids[i, sl] = s["input_ids"]
            indices[i, sl] = s["image_patches_indices"]
            mask[i, sl] = 1
            k = s["image_patches"].shape[0]
            patch_arr[i, :k] = s["image_patches"]
        return {
            "input_ids": input_ids,
            "image_patches": patch_arr,
            "image_patches_indices": indices,
            "attention_mask": mask,
        }

    # ── label handling (processing_fuyu.py:324-368) ─────────────────

    def get_labels(self, input_ids: np.ndarray,
                   special_token_id: Optional[int] = None,
                   masking_number: int = -100) -> np.ndarray:
        tok = special_token_id if special_token_id is not None \
            else self.boa_id()
        labels = np.full_like(input_ids, masking_number)
        for i in range(input_ids.shape[0]):
            idx = np.nonzero(input_ids[i] == tok)[0]
            if len(idx) >= 2:
                start, end = idx[0], idx[1] + 1
                labels[i, start + 1:end] = input_ids[i, start + 1:end]
        return labels

    def find_and_remove_tokens(self, input_ids: np.ndarray,
                               labels: np.ndarray,
                               token_id: Optional[int] = None):
        """Replace the LAST occurrence with EOS when the token appears more
        than once (processing_fuyu.py:324-346)."""
        tok = token_id if token_id is not None else self.boa_id()
        input_ids = input_ids.copy()
        labels = labels.copy()
        eos = self.tokenizer.eos_token_id
        for i in range(input_ids.shape[0]):
            idx = np.nonzero(input_ids[i] == tok)[0]
            if len(idx) > 1:
                input_ids[i, idx[-1]] = eos
                labels[i, idx[-1]] = eos
        return input_ids, labels

    # ── box/point post-processing (processing_fuyu.py:642-750) ──────

    def post_process_box_coordinates(self, text: str,
                                     scale_h: float = 1.0,
                                     scale_w: float = 1.0) -> str:
        """Convert raw coordinate spans <box>y1, x1, y2, x2</box> /
        <point>x, y</point> from half-scale token space back to image
        coordinates (the reference transforms token streams; we operate on
        the decoded text form)."""
        import re

        def fix_box(m):
            nums = [float(x) for x in m.group(1).split(",")]
            if len(nums) == 4:
                y1, x1, y2, x2 = [n * 2 for n in nums]
                return (f"<box>{y1 * scale_h:.0f}, {x1 * scale_w:.0f}, "
                        f"{y2 * scale_h:.0f}, {x2 * scale_w:.0f}</box>")
            return m.group(0)

        def fix_point(m):
            nums = [float(x) for x in m.group(1).split(",")]
            if len(nums) == 2:
                x, y = [n * 2 for n in nums]
                return f"<point>{x * scale_w:.0f}, {y * scale_h:.0f}</point>"
            return m.group(0)

        text = re.sub(r"<box>([^<]+)</box>", fix_box, text)
        text = re.sub(r"<point>([^<]+)</point>", fix_point, text)
        return text
