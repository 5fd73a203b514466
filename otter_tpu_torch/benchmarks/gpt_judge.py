"""GPT-judge plumbing shared by MagnifierBench/MMVet/MathVista scoring
(reference `datasets/magnifierbench.py:24-70`): OpenAI-compatible chat
completion with retry/backoff, plus an offline heuristic fallback so the
harness runs without an API key."""

from __future__ import annotations

import json
import os
import re
import time
from typing import Optional

OPENAI_URL = "https://api.openai.com/v1/chat/completions"


def get_chat_response(prompt: str, api_key: Optional[str] = None,
                      model: str = "gpt-4-0613", temperature: float = 0,
                      max_tokens: int = 256, patience: int = 5,
                      sleep_time: int = 5,
                      system: str = ("You are a helpful AI assistant. Your "
                                     "task is to judge whether the model "
                                     "response is correct to answer the "
                                     "given question or not.")) -> str:
    import requests
    api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
    if not api_key:
        return ""
    headers = {"Authorization": f"Bearer {api_key}",
               "Content-Type": "application/json"}
    payload = {"model": model, "temperature": temperature,
               "max_tokens": max_tokens,
               "messages": [{"role": "system", "content": system},
                            {"role": "user", "content": prompt}]}
    while patience > 0:
        patience -= 1
        try:
            r = requests.post(OPENAI_URL, headers=headers,
                              data=json.dumps(payload), timeout=30)
            r.raise_for_status()
            out = r.json()["choices"][0]["message"]["content"].strip()
            if out:
                return out
        except Exception as e:
            if "Rate limit" not in str(e):
                print(f"judge error: {e}")
            time.sleep(sleep_time)
    return ""


def _normalize(s: str) -> str:
    return re.sub(r"[^a-z0-9 ]", "", s.lower()).strip()


def heuristic_judge(question: str, response: str, answer: str) -> bool:
    """Offline fallback: normalized exact/substring match."""
    r, a = _normalize(response), _normalize(answer)
    return bool(a) and (r == a or a in r or r in a and len(r) > 0)


def judge_correct(question: str, response: str, answer: str,
                  api_key: Optional[str] = None) -> bool:
    """GPT-judged yes/no; falls back to heuristic matching offline."""
    prompt = (f"Question: {question}\nModel Response: {response}\n"
              f"Ground Truth: {answer}\nWill the model response be "
              "considered correct? You should only answer yes or no.")
    verdict = get_chat_response(prompt, api_key)
    if verdict:
        return verdict.strip().lower().startswith("yes")
    return heuristic_judge(question, response, answer)
