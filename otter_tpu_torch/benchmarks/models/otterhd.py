from otter_tpu_torch.benchmarks.models.fuyu import OtterHD  # noqa: F401
