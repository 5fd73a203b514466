"""Label masking and image preprocessing for MIMIC-IT (counterpart of
`otter_tpu/data/mimicit.py`).

Three functions are here, copied as they are: `mask_answer_labels` and
`find_and_remove_tokens` (the trainer's `prepare_batch`) and
`preprocess_image` (the serving worker's image decode; PIL is imported
inside it). The rest of the file (the dataset, its collation and the
loader) comes with the loader slice (ROADMAP Queue 1, item 8.1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from otter_tpu_torch.data import templates


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


def preprocess_image(img, size: int, mean=templates.FLAMINGO_MEAN,
                     std=templates.FLAMINGO_STD) -> np.ndarray:
    """bicubic resize -> [0,1] -> normalize; returns CHW float32
    (`patch_resize_transform`, mimicit_dataset.py:134-143)."""
    from PIL import Image
    img = img.resize((size, size), Image.BICUBIC)
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return arr.transpose(2, 0, 1)
