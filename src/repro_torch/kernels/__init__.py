"""Hand-written Hopper kernels (CUDA sources in ../csrc), their plain
PyTorch versions, and the dispatch entry points (`ops`)."""
