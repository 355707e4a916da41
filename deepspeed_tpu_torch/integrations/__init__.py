"""Bridges to other libraries' formats (``hf``: the HF state_dict names and
safetensors files)."""
