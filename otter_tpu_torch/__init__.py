"""otter_tpu_torch: the PyTorch/CUDA port of `otter_tpu` for NVIDIA Hopper.

The package imports torch and numpy only; it never imports jax, flax or
`otter_tpu`. Its entry points run on the GPU unless the caller passes
`device="cpu"`. Hand-written kernels live in `csrc/` and are built with
nvcc at first use (`_build.py`).
"""

__version__ = "0.1.0"
