"""Shared raw-image coercion for third-party benchmark adapters
(the per-adapter `get_pil_image` duplication in the reference,
e.g. `pipeline/benchmarks/models/instructblip.py:13-25`)."""

from __future__ import annotations

import io


def to_pil(raw_image_data):
    """PIL image | {'bytes': ...} (HF datasets) | base64 str -> PIL."""
    from PIL import Image
    if isinstance(raw_image_data, Image.Image):
        return raw_image_data
    if isinstance(raw_image_data, dict) and "bytes" in raw_image_data:
        return Image.open(io.BytesIO(raw_image_data["bytes"]))
    if isinstance(raw_image_data, bytes):
        return Image.open(io.BytesIO(raw_image_data))
    if isinstance(raw_image_data, str):
        from otter_tpu_torch.data.mimicit import decode_base64_image
        return decode_base64_image(raw_image_data)
    raise ValueError(
        f"unsupported image data format: {type(raw_image_data)!r}")
