"""Joint image+target transforms for region-aware tasks (a copy of
`otter_tpu/data/transforms.py`; PIL is imported where it is used).

Torch/torchvision-free rebuild of `pipeline/mimicit_utils/transforms.py`
(crop :15, hflip :72, resize :95, CenterCrop :168, ObjectCenterCrop :180,
RandomHorizontalFlip :207, RandomResize :217, Normalize :237, Compose :265,
LargeScaleJitter :283, RandomDistortion :520). Targets are dicts of numpy
arrays: boxes [N,4] xyxy, labels [N], area [N], optional masks [N,H,W].
"""

from __future__ import annotations

import random
from typing import Optional, Sequence, Tuple

import numpy as np


def crop(image, target: Optional[dict],
         region: Tuple[int, int, int, int], delete: bool = True):
    """region = (top, left, h, w)."""
    i, j, h, w = region
    cropped = image.crop((j, i, j + w, i + h))
    if target is None:
        return cropped, None
    target = dict(target)
    target["size"] = np.asarray([h, w])
    fields = [f for f in ("labels", "area") if f in target]
    if "boxes" in target:
        boxes = np.asarray(target["boxes"], np.float32)
        boxes = boxes - np.asarray([j, i, j, i], np.float32)
        boxes = boxes.reshape(-1, 2, 2)
        boxes = np.minimum(boxes, np.asarray([w, h], np.float32))
        boxes = np.clip(boxes, 0, None)
        area = np.prod(boxes[:, 1] - boxes[:, 0], axis=1)
        target["boxes"] = boxes.reshape(-1, 4)
        target["area"] = area
        fields.append("boxes")
    if "masks" in target:
        target["masks"] = target["masks"][:, i:i + h, j:j + w]
        fields.append("masks")
    if delete and ("boxes" in target or "masks" in target):
        if "boxes" in target:
            b = target["boxes"].reshape(-1, 2, 2)
            keep = np.all(b[:, 1] > b[:, 0], axis=1)
        else:
            keep = target["masks"].reshape(
                target["masks"].shape[0], -1).any(1)
        for f in set(fields):
            target[f] = np.asarray(target[f])[keep]
    return cropped, target


def hflip(image, target: Optional[dict]):
    from PIL import Image
    flipped = image.transpose(Image.FLIP_LEFT_RIGHT)
    if target is None:
        return flipped, None
    w, _ = image.size
    target = dict(target)
    if "boxes" in target:
        b = np.asarray(target["boxes"], np.float32)
        target["boxes"] = b[:, [2, 1, 0, 3]] * np.asarray(
            [-1, 1, -1, 1], np.float32) + np.asarray([w, 0, w, 0],
                                                     np.float32)
    if "masks" in target:
        target["masks"] = target["masks"][:, :, ::-1]
    return flipped, target


def resize(image, target: Optional[dict], size,
           max_size: Optional[int] = None):
    """size: int (short side) or (h, w)."""
    from PIL import Image
    w, h = image.size
    if isinstance(size, (list, tuple)):
        oh, ow = size
    else:
        short, long = min(w, h), max(w, h)
        scale = size / short
        if max_size is not None and long * scale > max_size:
            scale = max_size / long
        ow, oh = int(round(w * scale)), int(round(h * scale))
    rescaled = image.resize((ow, oh), Image.BILINEAR)
    if target is None:
        return rescaled, None
    rw, rh = ow / w, oh / h
    target = dict(target)
    if "boxes" in target:
        target["boxes"] = np.asarray(target["boxes"], np.float32) * \
            np.asarray([rw, rh, rw, rh], np.float32)
    if "area" in target:
        target["area"] = np.asarray(target["area"], np.float32) * rw * rh
    target["size"] = np.asarray([oh, ow])
    if "masks" in target and target["masks"].size:
        masks = [np.asarray(Image.fromarray(m.astype(np.uint8)).resize(
            (ow, oh), Image.NEAREST)) for m in target["masks"]]
        target["masks"] = np.stack(masks).astype(bool)
    return rescaled, target


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, image, target=None):
        for t in self.transforms:
            image, target = t(image, target)
        return image, target


class CenterCrop:
    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, image, target=None):
        w, h = image.size
        ch, cw = self.size
        top = int(round((h - ch) / 2.0))
        left = int(round((w - cw) / 2.0))
        return crop(image, target, (top, left, ch, cw))


class ObjectCenterCrop:
    """Crop centered on the (first) target box (transforms.py:180-205)."""

    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, image, target):
        w, h = image.size
        ch, cw = self.size
        box = np.asarray(target["boxes"], np.float32)[0]
        cx = (box[0] + box[2]) / 2
        cy = (box[1] + box[3]) / 2
        left = int(np.clip(cx - cw / 2, 0, max(w - cw, 0)))
        top = int(np.clip(cy - ch / 2, 0, max(h - ch, 0)))
        return crop(image, target, (top, left, ch, cw), delete=False)


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, image, target=None):
        if random.random() < self.p:
            return hflip(image, target)
        return image, target


class RandomResize:
    def __init__(self, sizes: Sequence, max_size: Optional[int] = None):
        self.sizes = list(sizes)
        self.max_size = max_size

    def __call__(self, image, target=None):
        return resize(image, target, random.choice(self.sizes),
                      self.max_size)


class ToArray:
    """PIL -> float32 CHW in [0,1] (the ToTensor equivalent)."""

    def __call__(self, image, target=None):
        arr = np.asarray(image.convert("RGB"), np.float32) / 255.0
        return arr.transpose(2, 0, 1), target


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32).reshape(3, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(3, 1, 1)

    def __call__(self, array, target=None):
        return (array - self.mean) / self.std, target


class LargeScaleJitter:
    """Random scale jitter in [min_scale, max_scale] of output_size, then
    random crop/pad to output_size² (transforms.py:283-399)."""

    def __init__(self, output_size: int = 512, min_scale: float = 0.3,
                 max_scale: float = 2.0):
        self.output_size = output_size
        self.min_scale = min_scale
        self.max_scale = max_scale

    def __call__(self, image, target=None):
        scale = self.min_scale + random.random() * (
            self.max_scale - self.min_scale)
        w, h = image.size
        scale = scale * self.output_size / max(h, w)
        image, target = resize(image, target,
                               (int(h * scale), int(w * scale)))
        w, h = image.size
        if h > self.output_size or w > self.output_size:
            top = random.randint(0, max(h - self.output_size, 0))
            left = random.randint(0, max(w - self.output_size, 0))
            image, target = crop(
                image, target,
                (top, left, min(self.output_size, h),
                 min(self.output_size, w)))
        w, h = image.size
        if h < self.output_size or w < self.output_size:
            from PIL import Image
            padded = Image.new("RGB", (self.output_size, self.output_size))
            padded.paste(image, (0, 0))
            image = padded
            if target is not None:
                target = dict(target)
                target["size"] = np.asarray([self.output_size,
                                             self.output_size])
        return image, target


class RandomDistortion:
    """Photometric distortion: brightness/contrast/saturation
    (transforms.py:520+)."""

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, hue: float = 0.0, prob: float = 0.5):
        self.factors = (brightness, contrast, saturation)
        self.prob = prob

    def __call__(self, image, target=None):
        if random.random() > self.prob:
            return image, target
        from PIL import ImageEnhance
        for enhancer, f in zip(
                (ImageEnhance.Brightness, ImageEnhance.Contrast,
                 ImageEnhance.Color), self.factors):
            factor = 1.0 + random.uniform(-f, f)
            image = enhancer(image).enhance(factor)
        return image, target
