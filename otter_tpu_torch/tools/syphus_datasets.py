"""Per-dataset syphus adapters: annotation files -> [{id, sentences}]
query inputs (reference `mimic-it/syphus/datasets/{3d,change,fpv,funqa,
translate,video}.py`), built on the generic AbstractDataset machinery in
`otter_tpu_torch/tools/syphus.py`. Prompt JSONs live in `tools/prompts/`
(vendored data assets — see prompts/README.md).

Each class documents the annotation schema it consumes; paths default to
the reference's layout but are constructor arguments.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List

from otter_tpu_torch.tools.syphus import AbstractDataset

PROMPTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "prompts")


def prompt_path(name: str) -> str:
    return os.path.join(PROMPTS_DIR, f"{name}.json")


class SceneNavigation(AbstractDataset):
    """ScanNet scene descriptions ({scene_id: {description: [[speaker,
    text], ...]}}) -> up to 50 shuffled description texts per scene
    (syphus/datasets/3d.py:11-40). Drives the SN dataset of MIMIC-IT."""

    def __init__(self, query_inputs_path: str,
                 prompt: str = prompt_path("scene_navigation"),
                 name: str = "SceneNavigation", seed: int = 0):
        self._seed = seed
        super().__init__(name, prompt, query_inputs_path)

    def _load_query_inputs(self, path: str) -> List[Dict[str, str]]:
        rng = random.Random(self._seed)
        with open(path) as f:
            data = json.load(f)
        out = []
        for scene_id, inner in data.items():
            desc = list(inner["description"])
            rng.shuffle(desc)
            texts = [d[1] for d in desc[:50]]
            out.append({"id": scene_id, "sentences": "\n".join(texts)})
        return out


class SpotTheDifference(AbstractDataset):
    """Spot-the-difference train.json ([{img_id, sentences: [...]}]) ->
    newline-joined difference sentences (syphus/datasets/change.py:11-33).
    Drives the SD dataset."""

    def __init__(self, query_inputs_path: str,
                 prompt: str = prompt_path("spot_the_difference"),
                 name: str = "SpotTheDifference"):
        super().__init__(name, prompt, query_inputs_path)

    def _load_query_inputs(self, path: str) -> List[Dict[str, str]]:
        with open(path) as f:
            data = json.load(f)
        return [{"id": d["img_id"], "sentences": "\n".join(d["sentences"])}
                for d in data]


class CocoSpotTheDifference(AbstractDataset):
    """COCO-SD csd_query.json ({file_id: {sentences}}) (change.py:36-64);
    drives the CGD dataset."""

    def __init__(self, query_inputs_path: str,
                 prompt: str = prompt_path("coco_spot_the_difference"),
                 name: str = "CocoSpotTheDifference"):
        super().__init__(name, prompt, query_inputs_path)

    def _load_query_inputs(self, path: str) -> List[Dict[str, str]]:
        with open(path) as f:
            data = json.load(f)
        return [{"id": k, "sentences": v["sentences"]}
                for k, v in data.items()]


class DenseCaptions(AbstractDataset):
    """ActivityNet-style dense captions ({video: {timestamps, sentences}})
    -> rounded timestamps + caption list (syphus/datasets/video.py:10-39).
    Drives the DC dataset."""

    def __init__(self, query_inputs_path: str,
                 prompt: str = prompt_path("dense_captions"),
                 name: str = "DenseCaptions"):
        super().__init__(name, prompt, query_inputs_path)

    def _load_query_inputs(self, path: str) -> List[Dict[str, str]]:
        with open(path) as f:
            data = json.load(f)
        out = []
        for vid, inner in data.items():
            ts = [[round(float(a)), round(float(b))]
                  for a, b in inner["timestamps"]]
            text = (f"timestamps: {ts}\n"
                    f"sentences: {json.dumps(inner['sentences'])}")
            out.append({"id": vid, "sentences": text})
        return out


class TVCaptions(AbstractDataset):
    """TVC jsonl ({vid_name, descs: [{desc}]}) -> numbered description list
    (video.py:42-59). Drives the TVC dataset."""

    def __init__(self, query_inputs_path: str,
                 prompt: str = prompt_path("tv_captions"),
                 name: str = "TVCaptions"):
        super().__init__(name, prompt, query_inputs_path)

    def _load_query_inputs(self, path: str) -> List[Dict[str, str]]:
        out = []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                video = json.loads(line)
                descs = [f"{i}. {d['desc']}"
                         for i, d in enumerate(video["descs"], 1)]
                out.append({"id": video["vid_name"],
                            "sentences": "\n".join(descs)})
        return out


class VisualStoryTelling(AbstractDataset):
    """VIST story-in-sequence JSON (images/annotations/albums) -> one query
    per album with per-image titles/tags/annotations (video.py:62-131).
    Drives the VST dataset."""

    def __init__(self, query_inputs_path: str,
                 prompt: str = prompt_path("visual_story_telling"),
                 name: str = "VisualStoryTelling"):
        super().__init__(name, prompt, query_inputs_path)

    def _load_query_inputs(self, path: str) -> List[Dict[str, str]]:
        with open(path) as f:
            data = json.load(f)
        images = {img["id"]: {"title": img["title"], "tags": img["tags"],
                              "annotations": []}
                  for img in data["images"]}
        for ann_list in data["annotations"]:
            for ann in ann_list:
                images[ann["photo_flickr_id"]]["annotations"].append(
                    ann["text"])
        albums = {a["id"]: {"title": a["title"],
                            "description": a["description"], "images": []}
                  for a in data["albums"]}
        for img in data["images"]:
            albums[img["album_id"]]["images"].append(images[img["id"]])

        out = []
        for album_id, album in albums.items():
            parts = [f"title: {album['title']}",
                     f"description: {album['description']}"]
            for img in album["images"]:
                parts += ["", f"image: {img['title']}",
                          f"tags: {img['tags']}",
                          f"annotations: {json.dumps(img['annotations'])}"]
            out.append({"id": album_id, "sentences": "\n".join(parts) + "\n"})
        return out


# FunQA instruction -> task-code table (syphus/datasets/funqa.py:20-33)
_FUNQA_TASKS = {
    "H1": "Find the videos humorous moment.",
    "H2": "Description of the videos humorous moment.",
    "H3": "Why is the whole video humorous.",
    "H4": "Please provide a caption for the video.",
    "C1": "Find the videos creative moment.",
    "C2": "Description of the videos creative moment.",
    "C3": "Why is the whole video creative.",
    "C4": "Please provide a caption for the video.",
    "C5": "Please score the videos creativity in [0-20].",
    "M1": "Find the videos magic moment.",
    "M2": "Description of the videos magic moment.",
    "M3": "Why is the whole video magic.",
}


def _funqa_task(instruction: str) -> str:
    vals = list(_FUNQA_TASKS.values())
    return list(_FUNQA_TASKS)[vals.index(instruction)]


class FunQATranslation(AbstractDataset):
    """FunQA annotations_tr.json -> one query per description/caption item
    (tasks *2/*3/*4; *1/*5 skipped — funqa.py:18-46)."""

    def __init__(self, query_inputs_path: str,
                 prompt: str = prompt_path("funqa_translation"),
                 name: str = "FunQA_translation"):
        super().__init__(name, prompt, query_inputs_path)

    def _load_query_inputs(self, path: str) -> List[Dict[str, str]]:
        with open(path) as f:
            data = json.load(f)
        out = []
        for item in data:
            task = _funqa_task(item["instruction"])
            if task[-1] in ("1", "5"):
                continue
            out.append({
                "id": item["visual_input"].split("/")[-1] + "_" + task,
                "sentences": item["output"]})
        return out


class _FunQAPaired(AbstractDataset):
    """FunQA mcqa/dia annotations: pairs each video's description (*2) with
    its counter-intuitive reason (*3) into one query (funqa.py:49-134)."""

    def _load_query_inputs(self, path: str) -> List[Dict[str, str]]:
        with open(path) as f:
            data = json.load(f)
        out = []
        desc = ""
        for item in data:
            task = _funqa_task(item["instruction"])
            if task[-1] == "2":
                desc = f"description: {item['output']}\n"
            elif task[-1] == "3":
                out.append({
                    "id": item["visual_input"].split("/")[-1],
                    "sentences":
                        desc + f"counter-intuitive reason: {item['output']}"})
        return out


class FunQAMcqa(_FunQAPaired):
    def __init__(self, query_inputs_path: str,
                 prompt: str = prompt_path("funqa_mcqa"),
                 name: str = "FunQA_mcqa"):
        super().__init__(name, prompt, query_inputs_path)


class FunQADia(_FunQAPaired):
    def __init__(self, query_inputs_path: str,
                 prompt: str = prompt_path("funqa_dia"),
                 name: str = "FunQA_dia"):
        super().__init__(name, prompt, query_inputs_path)


class EGO4D(AbstractDataset):
    """Ego4D narrations -> per-clip timestamped descriptions + the
    first-person phrasing restrictions appended (syphus/datasets/fpv.py:
    43-97). Drives the E4D dataset."""

    RESTRICTIONS = (
        "Remember, in your responses, avoid directly referencing specific "
        "timestamps. Refer to events or objects observed in the sequence "
        "of events, phrase observations as 'According to what I observed'. "
        "Refer to people only as 'the person' or 'a person'; 'Person C' or "
        "'C' mean the user wearing the AR glasses — use 'I' in questions "
        "and 'you' in answers and never the word 'cameraman'. Produce at "
        "least six concise first-person questions; what is observed is the "
        "real world, not a video.")

    def __init__(self, query_inputs_path: str,
                 prompt: str = prompt_path("ego4d"),
                 name: str = "EGO4D"):
        super().__init__(name, prompt, query_inputs_path)

    def _load_query_inputs(self, path: str) -> List[Dict[str, str]]:
        with open(path) as f:
            data = json.load(f)
        out = []
        for video_name, video in data.items():
            seen = set()
            for clip_id, clip in enumerate(video["clips"]):
                parts = []
                for narr in clip.get("narrations", []):
                    t = round(narr.get("time", 0))
                    objs = "; ".join(narr["object_description"])
                    if t in seen:
                        parts.append(f"description: {narr['text']}")
                    else:
                        seen.add(t)
                        parts.append(f"timestamp: {t}\n"
                                     f"description: {narr['text']}\n"
                                     f"objects: {objs}")
                text = "\n".join(parts) + "\n" + self.RESTRICTIONS
                out.append({"id": f"{video_name}_clip{clip_id:06d}",
                            "sentences": text})
        return out


class Translation(AbstractDataset):
    """English MIMIC-IT instruction JSON -> <a>instruction</a><b>answer</b>
    strings for LLM translation (syphus/datasets/translate.py)."""

    def __init__(self, query_inputs_path: str,
                 prompt: str = prompt_path("translation"),
                 name: str = "Translations"):
        super().__init__(name, prompt, query_inputs_path)

    def _load_query_inputs(self, path: str) -> List[Dict[str, str]]:
        with open(path) as f:
            data = json.load(f)["data"]
        return [{"id": k,
                 "sentences": f"<a>{v['instruction']}</a><b>{v['answer']}</b>"}
                for k, v in data.items()]


DATASET_REGISTRY = {
    "3d.SceneNavigation": SceneNavigation,
    "change.SpotTheDifference": SpotTheDifference,
    "change.CocoSpotTheDifference": CocoSpotTheDifference,
    "video.DenseCaptions": DenseCaptions,
    "video.TVCaptions": TVCaptions,
    "video.VisualStoryTelling": VisualStoryTelling,
    "funqa.FunQA_translation": FunQATranslation,
    "funqa.FunQA_mcqa": FunQAMcqa,
    "funqa.FunQA_dia": FunQADia,
    "fpv.EGO4D": EGO4D,
    "translate.Translation": Translation,
}
