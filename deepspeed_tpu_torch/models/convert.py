"""Weight bridge: a JAX parameter tree, as numpy arrays, into the port's
parameters, and the port's parameters back to numpy.

``deepspeed_tpu``'s ``init`` returns nested dicts with the layers stacked
along a leading [L] dim and projection weights [in, out]. The port keeps the
same tree and layout, so the bridge is a checked copy: every tensor the port's
``init`` would make must be present with the same shape. A weight-only
quantized leaf of the JAX package (a ``PackedWeight`` whose ``qdata`` and
``scale`` are numpy arrays, with ``shape``, ``bits``, ``dtype`` and
``nibbles``) becomes the port's ``PackedWeight`` with the same bytes: the two
packed layouts are identical.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..ops.quantizer import PackedWeight
from .transformer import Params, TransformerConfig, param_specs

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _is_packed(node) -> bool:
    return all(hasattr(node, a) for a in ("qdata", "scale", "shape", "bits", "nibbles"))


def params_from_numpy(cfg: TransformerConfig, tree: Mapping[str, Any], *,
                      dtype: Optional[torch.dtype] = None,
                      device="cpu") -> Params:
    """Nested dict of numpy arrays → the port's parameter tree of tensors
    on ``device`` (floating leaves cast to ``dtype`` when given)."""

    def convert(expected, node, path):
        if isinstance(expected, dict):
            if not isinstance(node, Mapping) or set(node) != set(expected):
                got = sorted(node) if isinstance(node, Mapping) else type(node).__name__
                raise ValueError(
                    f"params{path}: keys {got} != expected {sorted(expected)}"
                )
            return {k: convert(expected[k], node[k], f"{path}[{k!r}]")
                    for k in expected}
        if _is_packed(node):
            if tuple(node.shape) != expected[0]:
                raise ValueError(f"params{path}: shape {tuple(node.shape)} != {expected[0]}")
            pw_dtype = dtype or _TORCH_DTYPES[np.dtype(node.dtype).name]
            return PackedWeight(torch.from_numpy(np.array(node.qdata, dtype=np.int8)),
                                torch.from_numpy(np.array(node.scale, dtype=np.float32)),
                                node.shape, node.bits, pw_dtype,
                                node.nibbles).to(device)
        arr = np.asarray(node)
        if tuple(arr.shape) != expected[0]:
            raise ValueError(f"params{path}: shape {arr.shape} != {expected[0]}")
        t = torch.from_numpy(np.array(arr))  # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return convert(param_specs(cfg), tree, "")


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """The port's parameter tree → nested dict of numpy arrays (bf16 leaves
    as fp32), the inverse of :func:`params_from_numpy`: trained masters
    compare with the JAX engine's ``state.params``."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().to("cpu")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def cache_from_numpy(cache: Mapping[str, Any], *, device="cpu") -> Dict[str, torch.Tensor]:
    """A JAX KV arena, as numpy arrays, in the port's layout: contiguous
    {"k", "v"} [L, N, C, KV, hd] or paged [L, P+1, ps, KV, hd] carry over as
    they are; an int8 arena's scales [L, N, KV, C, SL] or [L, P+1, KV, ps, SL]
    keep their column 0, the port's one scale per (token, kv head)."""
    out = {name: torch.from_numpy(np.array(cache[name])).to(device) for name in ("k", "v")}
    for name in ("k_scale", "v_scale"):
        if name in cache:
            s = np.asarray(cache[name], np.float32)[..., 0]
            out[name] = torch.from_numpy(np.ascontiguousarray(s)).to(device)
    return out
