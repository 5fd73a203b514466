"""Syphus: LLM-driven instruction/response generation for MIMIC-IT.

Rebuild of `mimic-it/syphus/` (abstract_dataset.py, main.py:19-70,
file_utils.py): prompt JSONs ({system_message, in_context: [{role,
content}]}) + per-dataset query inputs -> chat-completion requests (any
OpenAI-compatible endpoint, the reference uses LiteLLM) -> parsed
instruction/answer pairs, threaded, checkpointed to JSON.
"""

from __future__ import annotations

import json
import os
import re
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional

AVAILABLE_DATASETS = [
    "change.SpotTheDifference", "change.CocoSpotTheDifference",
    "video.DenseCaptions", "video.TVCaptions", "video.VisualStoryTelling",
    "3d.SceneNavigation", "funqa.FunQA_translation", "funqa.FunQA_mcqa",
    "funqa.FunQA_dia", "fpv.EGO4D", "translate.Translation",
]
# concrete adapter classes + vendored prompt JSONs live in
# otter_tpu_torch/tools/syphus_datasets.py (DATASET_REGISTRY keyed by the names
# above) and otter_tpu_torch/tools/prompts/


def load_prompt(path: str) -> Dict[str, Any]:
    """Prompt JSON -> {system_message, in_context messages} with assistant
    QA pairs flattened to strings (abstract_dataset.py:28-52)."""
    with open(path) as f:
        data = json.load(f)
    in_context = []
    for conv in data["in_context"]:
        role, content = conv["role"], conv["content"]
        if role == "assistant" and not isinstance(content, str):
            parts = []
            for qa in content:
                for prefix, text in qa.items():
                    parts.append(f"{prefix}: {text}")
            content = "\n".join(parts) + "\n"
        elif role not in ("user", "assistant"):
            raise ValueError("only user/assistant roles allowed")
        in_context.append({"role": role, "content": content})
    return {"system_message": data["system_message"],
            "in_context": in_context}


class AbstractDataset(ABC):
    """Per-dataset adapter: yields annotation strings to be turned into
    instruction/answer pairs."""

    def __init__(self, name: str, prompt_path: str, query_inputs_path: str):
        self.name = name
        self.prompt = load_prompt(prompt_path)
        self.query_inputs = self._load_query_inputs(query_inputs_path)

    @abstractmethod
    def _load_query_inputs(self, path: str) -> List[Dict[str, str]]:
        """-> [{id, sentences}]."""

    def __len__(self):
        return len(self.query_inputs)

    def __iter__(self) -> Iterator[Dict[str, str]]:
        return iter(self.query_inputs)


class JsonAnnotationsDataset(AbstractDataset):
    """Generic adapter for {id: annotation-text} JSON files."""

    def _load_query_inputs(self, path: str) -> List[Dict[str, str]]:
        with open(path) as f:
            data = json.load(f)
        return [{"id": k, "sentences": v if isinstance(v, str)
                 else json.dumps(v)} for k, v in data.items()]


def parse_qa_pairs(response: str) -> List[Dict[str, str]]:
    """'instruction: ...\\nanswer: ...' blocks -> [{instruction, answer}]."""
    pairs = []
    pattern = re.compile(
        r"(?:instruction|question)\s*:\s*(.*?)\s*"
        r"(?:answer|response)\s*:\s*(.*?)(?=(?:instruction|question)\s*:|$)",
        re.IGNORECASE | re.DOTALL)
    for m in pattern.finditer(response):
        ins, ans = m.group(1).strip(), m.group(2).strip()
        if ins and ans:
            pairs.append({"instruction": ins, "answer": ans})
    return pairs


def openai_chat_fn(api_key: Optional[str] = None,
                   model: str = "gpt-4",
                   base_url: str = "https://api.openai.com/v1"
                   ) -> Callable[[List[dict]], str]:
    """Chat-completion callable for any OpenAI-compatible endpoint
    (the LiteLLM role in the reference, syphus/file_utils.py:53)."""
    import requests
    key = api_key or os.environ.get("OPENAI_API_KEY", "")

    def fn(messages: List[dict]) -> str:
        r = requests.post(
            f"{base_url}/chat/completions",
            headers={"Authorization": f"Bearer {key}"},
            json={"model": model, "messages": messages}, timeout=120)
        r.raise_for_status()
        return r.json()["choices"][0]["message"]["content"]

    return fn


def anthropic_chat_fn(api_key: Optional[str] = None,
                      model: str = "claude-3-5-sonnet-latest",
                      base_url: str = "https://api.anthropic.com",
                      max_tokens: int = 4096
                      ) -> Callable[[List[dict]], str]:
    """Anthropic Messages API (reference routes Anthropic via LiteLLM,
    syphus/file_utils.py:53): the system message moves to the top-level
    `system` field; user/assistant turns pass through."""
    import requests
    key = api_key or os.environ.get("ANTHROPIC_API_KEY", "")

    def fn(messages: List[dict]) -> str:
        system = "\n".join(m["content"] for m in messages
                           if m["role"] == "system")
        turns = [m for m in messages if m["role"] != "system"]
        r = requests.post(
            f"{base_url}/v1/messages",
            headers={"x-api-key": key,
                     "anthropic-version": "2023-06-01"},
            json={"model": model, "max_tokens": max_tokens,
                  "system": system, "messages": turns}, timeout=120)
        r.raise_for_status()
        return "".join(blk.get("text", "")
                       for blk in r.json()["content"])

    return fn


def azure_chat_fn(api_key: Optional[str] = None,
                  deployment: str = "gpt-4",
                  endpoint: Optional[str] = None,
                  api_version: str = "2024-02-01"
                  ) -> Callable[[List[dict]], str]:
    """Azure OpenAI chat completions (deployment-addressed URL + api-key
    header; same message/response schema as OpenAI)."""
    import requests
    key = api_key or os.environ.get("AZURE_OPENAI_API_KEY", "")
    endpoint = endpoint or os.environ.get("AZURE_OPENAI_ENDPOINT", "")

    def fn(messages: List[dict]) -> str:
        r = requests.post(
            f"{endpoint}/openai/deployments/{deployment}/chat/completions",
            params={"api-version": api_version},
            headers={"api-key": key},
            json={"messages": messages}, timeout=120)
        r.raise_for_status()
        return r.json()["choices"][0]["message"]["content"]

    return fn


def cohere_chat_fn(api_key: Optional[str] = None,
                   model: str = "command-r-plus",
                   base_url: str = "https://api.cohere.com"
                   ) -> Callable[[List[dict]], str]:
    """Cohere v2 chat (same user/assistant/system message schema)."""
    import requests
    key = api_key or os.environ.get("COHERE_API_KEY", "")

    def fn(messages: List[dict]) -> str:
        r = requests.post(
            f"{base_url}/v2/chat",
            headers={"Authorization": f"Bearer {key}"},
            json={"model": model, "messages": messages}, timeout=120)
        r.raise_for_status()
        return "".join(blk.get("text", "") for blk in
                       r.json()["message"]["content"])

    return fn


PROVIDERS = ("openai", "anthropic", "azure", "cohere")


def make_chat_fn(provider: str = "openai", **kwargs
                 ) -> Callable[[List[dict]], str]:
    """Provider dispatch (the reference's LiteLLM multi-provider routing,
    syphus/file_utils.py:53): openai | anthropic | azure | cohere.
    Late-bound through module globals so tests can monkeypatch a
    provider's chat_fn."""
    if provider not in PROVIDERS:
        raise ValueError(f"unknown provider {provider!r}; "
                         f"available: {sorted(PROVIDERS)}")
    return globals()[f"{provider}_chat_fn"](**kwargs)


def generate_instructions(dataset: AbstractDataset,
                          chat_fn: Callable[[List[dict]], str],
                          *, num_threads: int = 8,
                          output_path: Optional[str] = None) -> Dict:
    """Self-instruct loop (syphus/main.py:19-70): system message +
    in-context examples + annotation -> QA pairs; threaded; returns the
    MIMIC-IT instruction JSON {"data": {id: {instruction, answer, ...}}}."""

    def query(item):
        messages = ([{"role": "system",
                      "content": dataset.prompt["system_message"]}]
                    + dataset.prompt["in_context"]
                    + [{"role": "user", "content": item["sentences"]}])
        try:
            response = chat_fn(messages)
        except Exception as e:
            return item["id"], [], str(e)
        return item["id"], parse_qa_pairs(response), None

    data = {}
    errors = {}
    with ThreadPoolExecutor(num_threads) as pool:
        for qid, pairs, err in pool.map(query, dataset):
            if err:
                errors[qid] = err
                continue
            for i, pair in enumerate(pairs):
                data[f"{dataset.name}_{qid}_{i}"] = {
                    "instruction": pair["instruction"],
                    "answer": pair["answer"],
                    "image_ids": [qid],
                    "rel_ins_ids": [],
                }
    result = {"data": data, "errors": errors}
    if output_path:
        with open(output_path, "w") as f:
            json.dump(result, f)
    return result


def main(argv=None):
    """CLI mirroring the reference `mimic-it/syphus/main.py` (--name
    selects the dataset adapter; endpoint via env or flags)."""
    import argparse

    from otter_tpu_torch.tools.syphus_datasets import DATASET_REGISTRY

    p = argparse.ArgumentParser("syphus")
    p.add_argument("--name", required=True,
                   choices=sorted(DATASET_REGISTRY),
                   help="dataset adapter (reference --name)")
    p.add_argument("--query_inputs", required=True,
                   help="path to the source annotations file")
    p.add_argument("--output", required=True,
                   help="output MIMIC-IT instruction JSON")
    p.add_argument("--num_threads", type=int, default=8)
    p.add_argument("--provider", default="openai",
                   choices=sorted(PROVIDERS),
                   help="chat backend (the reference's LiteLLM routing)")
    p.add_argument("--model", default=None)
    p.add_argument("--base_url", default=None)
    args = p.parse_args(argv)

    dataset = DATASET_REGISTRY[args.name](args.query_inputs)
    kwargs = {}
    if args.model:
        kwargs["deployment" if args.provider == "azure"
               else "model"] = args.model
    if args.base_url:
        kwargs["endpoint" if args.provider == "azure"
               else "base_url"] = args.base_url
    elif args.provider == "openai" and os.environ.get("OPENAI_API_BASE"):
        kwargs["base_url"] = os.environ["OPENAI_API_BASE"]
    chat_fn = make_chat_fn(args.provider, **kwargs)
    result = generate_instructions(dataset, chat_fn,
                                   num_threads=args.num_threads,
                                   output_path=args.output)
    print(f"{args.name}: {len(result['data'])} instructions, "
          f"{len(result['errors'])} errors -> {args.output}")
    return result


if __name__ == "__main__":
    main()
