"""Run-time helpers of the trainer (counterpart of `otter_tpu/runtime/`):
metrics and logging (`metrics.py`), checkpoints (`checkpoint.py`), synced
timing (`timing.py`)."""
