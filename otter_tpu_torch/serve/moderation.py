# A copy of otter_tpu/serve/moderation.py (the port imports nothing of the JAX package);
# tests/test_torch_serve.py holds its output equal to the original's.
"""Content-moderation gate for the web UI (reference
`pipeline/serve/serving_utils.py:105-123` + the `--moderate` flag,
`gradio_web_server.py:229-242,896`): user text is checked against the
OpenAI moderation API before generation; failures fail OPEN (no block)
exactly like the reference."""

from __future__ import annotations

import json
import os

MODERATION_MSG = ("YOUR INPUT VIOLATES OUR CONTENT MODERATION GUIDELINES. "
                  "PLEASE TRY AGAIN.")


def violates_moderation(text: str, *, endpoint: str = None,
                        api_key: str = None, timeout: float = 25.0) -> bool:
    """True if the moderation endpoint flags `text`. Without an API key the
    check is a no-op (False) — matching the reference's fail-open behavior
    on request errors."""
    import requests

    api_key = api_key or os.environ.get("OPENAI_API_KEY")
    if not api_key:
        return False
    url = endpoint or "https://api.openai.com/v1/moderations"
    try:
        r = requests.post(
            url,
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {api_key}"},
            data=json.dumps({"input": text.replace("\n", "")}),
            timeout=timeout)
        return bool(r.json()["results"][0]["flagged"])
    except Exception:
        return False
