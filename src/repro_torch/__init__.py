"""LoongServe on PyTorch + CUDA: elastic sequence parallelism for
long-context LLM serving, ported from the JAX package `repro` (the
reference) to one NVIDIA H100.

Entry points run on ``device="cuda"`` unless the caller names the CPU; on a
CPU tensor every kernel wrapper runs its plain PyTorch version, on a CUDA
tensor the hand-written Hopper kernel (`csrc/`).
"""

__version__ = "0.1.0"
