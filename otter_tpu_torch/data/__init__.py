"""Data (counterpart of `otter_tpu/data/`): the MIMIC-IT dataset, its
collation and label masking (`mimicit.py`), the data YAML gate
(`yaml_spec.py`), the sharded prefetching loaders (`loader.py`), the
joint image+target transforms (`transforms.py`), the tokenizer adaptation
(`tokenizer_adapt.py`), the prompt templates (`templates.py`) and the Fuyu
processor (`fuyu_processor.py`). Exports what the JAX package's does."""

from otter_tpu_torch.data.loader import MimicitLoader, WeightedMultiLoader
from otter_tpu_torch.data.mimicit import (
    MimicitDataset,
    MimicitTask,
    mask_answer_labels,
    find_and_remove_tokens,
)
from otter_tpu_torch.data.yaml_spec import (
    DataSpecError,
    load_yaml,
    tasks_from_spec,
    validate_spec,
    verify_yaml,
)
