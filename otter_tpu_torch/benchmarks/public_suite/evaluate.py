"""OpenFlamingo-style public-datasets eval suite (counterpart of
`otter_tpu/benchmarks/public_suite/evaluate.py`, the reference's
`pipeline/benchmarks/public_datasets_suite/evaluate.py:367+`):
COCO/Flickr captioning (CIDEr), VQAv2/OK-VQA/TextVQA/VizWiz (VQA accuracy),
ImageNet/HatefulMemes (rank classification), with k-shot in-context
examples (0/4/8/16/32) and data-parallel sharding over the ranks of a
`torch.distributed` process group (replacing the reference's DDP sharded
inference, eval_model.py:21-22).

Every process scores the SAME global result set: per-shard predictions are
all-gathered across processes before scoring (the reference gathers via
DDP before computing metrics). Generation is batched through the model's
`generate_batch` when available (reference `eval_model.py:21-60` batches
through `get_outputs`).

Datasets are provided as local JSON manifests:
  captioning: [{image: path|PIL, caption/captions}]
  vqa:        [{image, question, answers: [str]}]
  classification: [{image, class_id}]

    torchrun --nproc_per_node 4 \
        -m otter_tpu_torch.benchmarks.public_suite.evaluate \
        --multi_host --dataset vqav2 --test_manifest test.json ...
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Sequence

from otter_tpu_torch.benchmarks.public_suite.coco_metric import (
    compute_cider, postprocess_captioning_generation)
from otter_tpu_torch.benchmarks.public_suite.vqa_metric import (
    compute_vqa_accuracy, postprocess_vqa_generation)
from otter_tpu_torch.benchmarks.public_suite.classification_utils import (
    rank_classification)


def _shard(items: Sequence, rank: int, world: int) -> List:
    return list(items)[rank::world]


def gather_results(local: List[dict]) -> List[dict]:
    """All-gather JSON-serializable per-shard results across the ranks of
    the default process group, in rank order, so every process scores the
    identical global set. Without a group (or at one rank): the
    identity."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return list(local)
    shards: List = [None] * dist.get_world_size()
    dist.all_gather_object(shards, list(local))
    return [r for shard in shards for r in shard]


def _image(ref):
    """A manifest's image: a path to an image file opens as an RGB PIL
    image (what the adapters take); anything else passes through."""
    if isinstance(ref, str) and os.path.isfile(ref):
        from PIL import Image
        with Image.open(ref) as img:
            return img.convert("RGB")
    return ref


def _batched_generate(model, prompts: List[str], images: List) -> List[str]:
    """Chunk through model.generate_batch when available (one batched decode),
    item-wise model.generate otherwise."""
    gen_batch = getattr(model, "generate_batch", None)
    if gen_batch is None:
        return [model.generate(p, im) for p, im in zip(prompts, images)]
    bs = max(int(getattr(model, "max_batch_size", 1)), 1)
    out: List[str] = []
    for i in range(0, len(prompts), bs):
        out.extend(gen_batch(prompts[i: i + bs], images[i: i + bs]))
    return out


def _sample_shots(rng: random.Random, train_items: Sequence, k: int,
                  exclude_idx: int) -> List:
    pool = [x for i, x in enumerate(train_items) if i != exclude_idx]
    return rng.sample(pool, min(k, len(pool))) if k else []


def evaluate_captioning(model, *, test_items: Sequence[dict],
                        train_items: Sequence[dict] = (),
                        num_shots: int = 0, seed: int = 42,
                        rank: int = 0, world: int = 1,
                        dataset_name: str = "coco") -> float:
    """Few-shot captioning; returns the GLOBAL CIDEr (same on every
    process)."""
    rng = random.Random(seed)
    shard = _shard(test_items, rank, world)
    prompts, images, metas = [], [], []
    for i, item in enumerate(shard):
        shots = _sample_shots(rng, train_items, num_shots, -1)
        context = "".join(
            f"<image>Output:{s['caption']}<|endofchunk|>" for s in shots)
        prompts.append(context + "Output:")
        images.append(_image(item["image"]))
        metas.append(item)
    preds = _batched_generate(model, prompts, images)
    local = []
    for i, (item, pred) in enumerate(zip(metas, preds)):
        img_id = str(item.get("image_id", f"{rank}:{i}"))
        local.append({"image_id": img_id,
                      "caption": postprocess_captioning_generation(pred),
                      "refs": item.get("captions") or [item["caption"]]})
    merged = gather_results(local)
    results = [{"image_id": r["image_id"], "caption": r["caption"]}
               for r in merged]
    annotations = {r["image_id"]: r["refs"] for r in merged}
    return compute_cider(results, annotations)


def evaluate_vqa(model, *, test_items: Sequence[dict],
                 train_items: Sequence[dict] = (), num_shots: int = 0,
                 seed: int = 42, rank: int = 0, world: int = 1,
                 dataset_name: str = "vqav2") -> float:
    """Few-shot VQA; returns the GLOBAL VQA accuracy (0..100). OK-VQA
    applies the official answer stemming (ok_vqa_utils.py)."""
    rng = random.Random(seed)
    if dataset_name == "ok_vqa":
        from otter_tpu_torch.benchmarks.public_suite.ok_vqa_utils import (
            postprocess_ok_vqa_generation as postprocess)
    else:
        postprocess = postprocess_vqa_generation
    shard = _shard(test_items, rank, world)
    prompts, images, metas = [], [], []
    for i, item in enumerate(shard):
        shots = _sample_shots(rng, train_items, num_shots, -1)
        context = "".join(
            f"<image>Question:{s['question']} Short answer:"
            f"{s['answers'][0]}<|endofchunk|>" for s in shots)
        prompts.append(context
                       + f"Question:{item['question']} Short answer:")
        images.append(_image(item["image"]))
        metas.append(item)
    preds = _batched_generate(model, prompts, images)
    local = [{"prediction": postprocess(pred), "answers": item["answers"]}
             for item, pred in zip(metas, preds)]
    return compute_vqa_accuracy(gather_results(local))


def evaluate_classification(model, *, test_items: Sequence[dict],
                            classnames: Sequence[str],
                            prompt: str = "A photo of",
                            rank: int = 0, world: int = 1) -> float:
    """Rank classification; returns the GLOBAL accuracy (0..100)."""
    local = []
    for item in _shard(test_items, rank, world):
        pred = rank_classification(model, prompt, _image(item["image"]),
                                   classnames)
        local.append({"correct": int(pred == int(item["class_id"]))})
    merged = gather_results(local)
    return 100.0 * sum(r["correct"] for r in merged) / max(len(merged), 1)


EVAL_FNS = {
    "coco": evaluate_captioning,
    "flickr": evaluate_captioning,
    "vqav2": evaluate_vqa,
    "ok_vqa": evaluate_vqa,
    "textvqa": evaluate_vqa,
    "vizwiz": evaluate_vqa,
    "imagenet": evaluate_classification,
    "hateful_memes": evaluate_classification,
}


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="otter_image")
    p.add_argument("--model_path", default="")
    p.add_argument("--tokenizer", default="")
    p.add_argument("--dataset", required=True, choices=sorted(EVAL_FNS))
    p.add_argument("--test_manifest", required=True)
    p.add_argument("--train_manifest", default=None)
    p.add_argument("--classnames_file", default=None)
    p.add_argument("--shots", type=int, nargs="+", default=[0, 4, 8])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="the model's device (default: the GPU)")
    p.add_argument("--multi_host", action="store_true",
                   help="start the torch.distributed process group "
                        "(parallel.distributed.init_distributed_device) "
                        "before eval; each rank scores its shard")
    args = p.parse_args(argv)
    rank, world = 0, 1
    if args.multi_host:
        from otter_tpu_torch.parallel.distributed import (
            distributed_device, init_distributed_device)
        rank, world = init_distributed_device(args.device)
        args.device = distributed_device(args.device)

    from otter_tpu_torch.benchmarks.models.base_model import load_model
    model_args = {"model_path": args.model_path,
                  "tokenizer": args.tokenizer}
    if args.device is not None:
        model_args["device"] = args.device
    model = load_model(args.model, model_args)
    with open(args.test_manifest) as f:
        test_items = json.load(f)
    train_items = []
    if args.train_manifest:
        with open(args.train_manifest) as f:
            train_items = json.load(f)

    fn = EVAL_FNS[args.dataset]
    scores = []
    for shots in args.shots:
        if args.dataset in ("imagenet", "hateful_memes"):
            from otter_tpu_torch.benchmarks.public_suite.classification_utils \
                import HM_CLASSNAMES, load_classnames
            if args.classnames_file:
                names = load_classnames(args.classnames_file)
            elif args.dataset == "imagenet":
                names = load_classnames()     # vendored 1000-name list
            else:
                names = HM_CLASSNAMES
            score = fn(model, test_items=test_items, classnames=names,
                       rank=rank, world=world)
        else:
            score = fn(model, test_items=test_items,
                       train_items=train_items, num_shots=shots,
                       seed=args.seed, rank=rank, world=world,
                       dataset_name=args.dataset)
        scores.append(score)
        if rank == 0:
            print(json.dumps({"dataset": args.dataset, "shots": shots,
                              "score": score}))
    return scores


if __name__ == "__main__":
    main()
