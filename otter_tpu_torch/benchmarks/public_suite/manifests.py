"""Manifest loaders for the public-datasets suite: convert the official
annotation formats into the suite's item dicts.

Covers the file formats the reference suite consumes
(`public_datasets_suite/evaluate.py` arg surface: coco/flickr karpathy
splits, VQAv2-style question+annotation JSON, hateful memes jsonl).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional


def load_coco_captions(annotations_json: str, images_dir: str,
                       limit: Optional[int] = None) -> List[dict]:
    """Official COCO captions JSON ({"images": [...], "annotations":
    [{image_id, caption}]}) -> [{image, image_id, captions}]."""
    with open(annotations_json) as f:
        data = json.load(f)
    caps = defaultdict(list)
    for ann in data["annotations"]:
        caps[ann["image_id"]].append(ann["caption"])
    items = []
    for img in data["images"]:
        if img["id"] not in caps:
            continue
        items.append({
            "image": os.path.join(images_dir, img["file_name"]),
            "image_id": str(img["id"]),
            "captions": caps[img["id"]],
            "caption": caps[img["id"]][0],
        })
        if limit and len(items) >= limit:
            break
    return items


def load_karpathy_split(karpathy_json: str, images_root: str,
                        split: str = "test",
                        limit: Optional[int] = None) -> List[dict]:
    """Karpathy dataset_coco.json / dataset_flickr30k.json."""
    with open(karpathy_json) as f:
        data = json.load(f)
    items = []
    for img in data["images"]:
        if img.get("split") != split:
            continue
        path = os.path.join(images_root, img.get("filepath", ""),
                            img["filename"])
        captions = [s["raw"] for s in img["sentences"]]
        items.append({"image": path, "image_id": str(img.get("cocoid",
                                                             img["imgid"])),
                      "captions": captions, "caption": captions[0]})
        if limit and len(items) >= limit:
            break
    return items


def load_vqav2(questions_json: str, annotations_json: str, images_dir: str,
               image_name_fmt: str = "COCO_val2014_{:012d}.jpg",
               limit: Optional[int] = None) -> List[dict]:
    """Official VQAv2 questions + annotations -> [{image, question,
    answers}] (10 human answers per question)."""
    with open(questions_json) as f:
        questions = json.load(f)["questions"]
    with open(annotations_json) as f:
        anns = {a["question_id"]: a
                for a in json.load(f)["annotations"]}
    items = []
    for q in questions:
        ann = anns.get(q["question_id"])
        if ann is None:
            continue
        items.append({
            "image": os.path.join(images_dir,
                                  image_name_fmt.format(q["image_id"])),
            "question": q["question"],
            "answers": [a["answer"] for a in ann["answers"]],
            "question_id": q["question_id"],
        })
        if limit and len(items) >= limit:
            break
    return items


def load_hateful_memes(jsonl_path: str, images_root: str,
                       limit: Optional[int] = None) -> List[dict]:
    """hateful_memes dev/test jsonl ({img, label, text})."""
    items = []
    with open(jsonl_path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            items.append({"image": os.path.join(images_root, row["img"]),
                          "class_id": int(row["label"]),
                          "text": row.get("text", "")})
            if limit and len(items) >= limit:
                break
    return items
