"""Data helpers (counterpart of `otter_tpu/data/`): the trainer's label
masking and the serving worker's image preprocessing (`mimicit.py`), the
prompt templates (`templates.py`) and the Fuyu processor
(`fuyu_processor.py`), the last two copies of the JAX package's."""
