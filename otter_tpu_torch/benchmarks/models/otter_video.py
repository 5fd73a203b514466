from otter_tpu_torch.benchmarks.models.otter_image import (  # noqa: F401
    OtterVideo)
