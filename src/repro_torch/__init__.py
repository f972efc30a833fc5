"""PyTorch/CUDA port of `repro` (Nonuniform Tensor Parallelism) for Hopper.

The JAX package `repro` stays the reference; this package mirrors its
layout (`configs/`, `models/`, `kernels/`, `core/`, `reshard/`, `runtime/`,
`serve/`, `launch/`) with the same module and function names. It imports
`torch` and never `jax` or `repro`.

Every Pallas TPU kernel on a ported path is a hand-written CUDA kernel here
(`kernels/csrc/`), built with nvcc at first use. Entry points run on the GPU
unless the caller passes ``device="cpu"``; on the CPU each kernel wrapper
runs its plain PyTorch version (`kernels/ref.py`).

f32 means f32 on the card: TF32 is switched off for matmuls and cuDNN at
import, so float32 products keep full precision as in the reference.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
