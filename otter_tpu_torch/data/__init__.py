"""Data helpers (counterpart of `otter_tpu/data/`). Only the label masking
the trainer needs is here so far (`mimicit.py`)."""
