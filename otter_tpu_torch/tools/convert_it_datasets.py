"""Per-dataset convert-it adapters: public image/video sources ->
{image_id: base64} stores, over the generic packing machinery in
`otter_tpu_torch/tools/convert_it.py` (reference
`mimic-it/convert-it/datasets/{2d,3d,change,fpv,video}.py`).

Each adapter's `load()` returns {id: base64-PNG-224²} ready for
`convert_it.save_json` / `convert_json_to_parquet`, with id layouts
matching what the syphus adapters / MIMIC-IT instruction JSONs reference.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Dict, List

from otter_tpu_torch.tools.convert_it import image_to_base64


def _pack_paths(items, num_threads: int, resize_res: int) -> Dict[str, str]:
    """[(image_id, path)] -> {id: b64}, threaded, errors skipped."""
    def one(item):
        iid, path = item
        try:
            return iid, image_to_base64(path, resize_res)
        except Exception as e:
            print(f"skipping {path}: {e}")
            return None

    out = {}
    with ThreadPoolExecutor(max(num_threads, 1)) as pool:
        for r in pool.map(one, items):
            if r:
                out[r[0]] = r[1]
    return out


def _frame_video(path: str, resize_res: int) -> List[str]:
    """Video file -> list of base64 frames (reference image_utils.py
    frame_video; cv2 when present, imageio fallback)."""
    import base64
    import io
    from PIL import Image

    frames = []
    try:
        import cv2
        cap = cv2.VideoCapture(path)
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(Image.fromarray(frame[:, :, ::-1]))
        cap.release()
    except ImportError:
        import imageio.v3 as iio
        for frame in iio.imiter(path):
            frames.append(Image.fromarray(frame))
    out = []
    for img in frames:
        if resize_res > 0:
            img = img.resize((resize_res, resize_res), Image.BICUBIC)
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        out.append(base64.urlsafe_b64encode(buf.getvalue()).decode())
    return out


class Llava:
    """LA (2d.py): COCO train images named by the ids of a llava-style
    JSON; id layout `{image_id}` (file `{image_root}/{id}.jpg`)."""

    short_name = "LA"

    def __init__(self, *, image_root: str, image_path: str,
                 num_threads: int = 8, resize_res: int = 224):
        self.image_root = image_root
        self.image_path = image_path
        self.num_threads = num_threads
        self.resize_res = resize_res

    def load(self) -> Dict[str, str]:
        with open(self.image_path) as f:
            ids = list(json.load(f).keys())
        items = [(i, os.path.join(self.image_root, f"{i}.jpg"))
                 for i in ids]
        return _pack_paths(items, self.num_threads, self.resize_res)


class SceneNavigation:
    """SN (3d.py + scene_navigation_utils): scannet_frames_25k layout
    `{scene}/color/{frame}.jpg` -> id `{scene}_color_{frame}`."""

    short_name = "SN"

    def __init__(self, *, image_path: str, num_threads: int = 8,
                 resize_res: int = 224):
        self.image_path = image_path
        self.num_threads = num_threads
        self.resize_res = resize_res

    def load(self) -> Dict[str, str]:
        items = []
        for scene in sorted(os.listdir(self.image_path)):
            color = os.path.join(self.image_path, scene, "color")
            if not os.path.isdir(color):
                continue
            for f in sorted(os.listdir(color)):
                stem = os.path.splitext(f)[0]
                items.append((f"{scene}_color_{stem}",
                              os.path.join(color, f)))
        return _pack_paths(items, self.num_threads, self.resize_res)


class SpotTheDifference:
    """SD/CGD (change.py): folders of `{id}_1.*` / `{id}_2.*` image pairs
    -> both frames packed under their file stems."""

    short_name = "SD"

    def __init__(self, *, image_path: str, num_threads: int = 8,
                 resize_res: int = 224):
        self.image_path = image_path
        self.num_threads = num_threads
        self.resize_res = resize_res

    def load(self) -> Dict[str, str]:
        items = []
        for p in sorted(glob(os.path.join(self.image_path, "*"))):
            stem, ext = os.path.splitext(os.path.basename(p))
            if ext.lower() in (".jpg", ".jpeg", ".png", ".webp"):
                items.append((stem, p))
        return _pack_paths(items, self.num_threads, self.resize_res)


class CocoSpotTheDifference(SpotTheDifference):
    short_name = "CGD"


class EGO4D:
    """E4D (fpv.py): directory of ego4d videos -> every frame packed as
    `{video_name}_{index:08d}`."""

    short_name = "E4D"

    def __init__(self, *, image_path: str, num_threads: int = 4,
                 resize_res: int = 224):
        self.image_path = image_path
        self.num_threads = num_threads
        self.resize_res = resize_res

    def load(self) -> Dict[str, str]:
        out = {}

        def one(path):
            name = os.path.splitext(os.path.basename(path))[0]
            return name, _frame_video(path, self.resize_res)

        videos = sorted(glob(os.path.join(self.image_path, "*")))
        with ThreadPoolExecutor(max(self.num_threads, 1)) as pool:
            for name, frames in pool.map(one, videos):
                for i, b64 in enumerate(frames):
                    out[f"{name}_{i:08d}"] = b64
        return out


class DenseCaptions:
    """DC (video.py): directory of .mp4 -> frames `{video}_{idx:04d}`."""

    short_name = "DC"

    def __init__(self, *, image_path: str, num_threads: int = 4,
                 resize_res: int = 224, min_videos: int = 0):
        self.image_path = image_path
        self.num_threads = num_threads
        self.resize_res = resize_res
        self.min_videos = min_videos

    def load(self) -> Dict[str, str]:
        videos = sorted(glob(os.path.join(self.image_path, "*.mp4")))
        if len(videos) < self.min_videos:
            raise ValueError("Not enough videos in the dataset, please "
                             "check the path.")
        out = {}

        def one(path):
            name = os.path.splitext(os.path.basename(path))[0]
            return name, _frame_video(path, self.resize_res)

        with ThreadPoolExecutor(max(self.num_threads, 1)) as pool:
            for name, frames in pool.map(one, videos):
                for i, b64 in enumerate(frames):
                    out[f"{name}_{i:04d}"] = b64
        return out


class TVCaptions:
    """TVC (video.py:104-209): tvqa frame dirs `{show}/{clip}` -> 16
    uniformly-strided frames per clip as `{clip}_{idx:04d}`."""

    short_name = "TVC"

    def __init__(self, *, image_path: str, num_threads: int = 8,
                 resize_res: int = 224, frames: int = 16):
        self.image_path = image_path
        self.num_threads = num_threads
        self.resize_res = resize_res
        self.frames = frames

    def load(self) -> Dict[str, str]:
        items = []
        for show in sorted(os.listdir(self.image_path)):
            show_dir = os.path.join(self.image_path, show)
            if not os.path.isdir(show_dir):
                continue
            for clip in sorted(os.listdir(show_dir)):
                clip_dir = os.path.join(show_dir, clip)
                if not os.path.isdir(clip_dir):
                    continue
                files = sorted(glob(os.path.join(clip_dir, "*")))
                stride = max(1, len(files) // self.frames)
                start = stride // 2
                for i, idx in enumerate(range(start, len(files), stride)):
                    items.append((f"{clip}_{i:04d}", files[idx]))
        return _pack_paths(items, self.num_threads, self.resize_res)


class VisualStoryTelling:
    """VST (video.py:66-102 + visual_story_telling_utils): VIST
    train.story-in-sequence.json -> downloads each image by its flickr
    url; id = photo id. Network-dependent; url fields url_o/url_m."""

    short_name = "VST"

    def __init__(self, *, image_path: str, num_threads: int = 8,
                 resize_res: int = 224):
        self.image_path = image_path
        self.num_threads = num_threads
        self.resize_res = resize_res

    def load(self) -> Dict[str, str]:
        import base64
        import io
        import urllib.request
        from PIL import Image

        with open(self.image_path) as f:
            images = json.load(f)["images"]

        def one(img):
            url = img.get("url_o") or img.get("url_m")
            if not url:
                return None
            try:
                with urllib.request.urlopen(url, timeout=30) as r:
                    raw = r.read()
                pil = Image.open(io.BytesIO(raw)).convert("RGB")
                if self.resize_res > 0:
                    pil = pil.resize((self.resize_res, self.resize_res),
                                     Image.BICUBIC)
                buf = io.BytesIO()
                pil.save(buf, format="PNG")
                return img["id"], base64.urlsafe_b64encode(
                    buf.getvalue()).decode()
            except Exception as e:
                print(f"skipping {img.get('id')}: {e}")
                return None

        out = {}
        with ThreadPoolExecutor(max(self.num_threads, 1)) as pool:
            for r in pool.map(one, images):
                if r:
                    out[r[0]] = r[1]
        return out


DATASET_REGISTRY = {
    "2d.Llava": Llava,
    "3d.SceneNavigation": SceneNavigation,
    "change.SpotTheDifference": SpotTheDifference,
    "change.CocoSpotTheDifference": CocoSpotTheDifference,
    "fpv.EGO4D": EGO4D,
    "video.DenseCaptions": DenseCaptions,
    "video.TVCaptions": TVCaptions,
    "video.VisualStoryTelling": VisualStoryTelling,
}
