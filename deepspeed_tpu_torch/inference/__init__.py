"""Inference engine of the PyTorch/CUDA port."""

from .engine import InferenceEngine, init_inference  # noqa: F401
