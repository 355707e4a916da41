"""Ops of the PyTorch/CUDA port: attention and normalization dispatch, and
the hand-written CUDA kernels under ``ops.cuda``."""
