"""SFT training (counterpart of `otter_tpu/train/`): the step (`step.py`),
the argument surface (`args.py`) and the trainer loop (`sft.py`)."""
