"""HuggingFace Transformers bridge: the export half.

Counterpart of ``deepspeed_tpu/integrations/hf.py`` (``export_hf_state_dict``
line 251, ``_export_llama_trunk`` line 231, the safetensors I/O lines
488-555): the port's parameter tree (layers stacked along [L], projections
[in, out]) → an HF state_dict, per family, with the causal-LM wrapper prefix
(``model.`` / ``transformer.``), so ``load_state_dict`` takes it directly:

- llama/mistral: torch Linear [out, in], transposed;
- gpt2: Conv1D [in, out] as stored, q/k/v fused into ``c_attn``; the head is
  tied to ``wte``;
- bloom: q/k/v re-interleaved into ``query_key_value``'s [H, 3, hd, d]; the
  head is tied;
- mixtral: the llama trunk, the router, and per-expert ``w1`` (gate),
  ``w3`` (up) and ``w2`` (down).

The safetensors file is written without the ``safetensors`` package: an
8-byte little-endian header length, the JSON header {name: {dtype, shape,
data_offsets}}, then the raw little-endian tensors. A bf16 tensor's bytes go
out through its uint16 view (numpy has no bf16). The import half
(``import_hf_state_dict``, ``config_from_hf``) is ROADMAP A11.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict

import numpy as np
import torch

from ..runtime.checkpointing import numpy_dtype

HF_FAMILIES = ("llama", "mistral", "gpt2", "bloom", "mixtral")

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def _export_llama_trunk(out, p, cfg, L):
    """The llama/mistral/mixtral export but the MLP/MoE block: embeddings,
    norms, attention projections, lm_head."""
    out["model.embed_tokens.weight"] = p["embed"]["tok"]
    out["model.norm.weight"] = p["final_norm"]["scale"]
    if not cfg.tie_embeddings and "lm_head" in p:
        out["lm_head.weight"] = p["lm_head"].T
    at = p["layers"]["attn"]
    for i in range(L):
        pre = f"model.layers.{i}."
        out[pre + "input_layernorm.weight"] = p["layers"]["ln1"]["scale"][i]
        out[pre + "post_attention_layernorm.weight"] = p["layers"]["ln2"]["scale"][i]
        out[pre + "self_attn.q_proj.weight"] = at["wq"][i].T
        out[pre + "self_attn.k_proj.weight"] = at["wk"][i].T
        out[pre + "self_attn.v_proj.weight"] = at["wv"][i].T
        out[pre + "self_attn.o_proj.weight"] = at["wo"][i].T


def export_hf_state_dict(params: Dict[str, Any], cfg, family: str) -> Dict[str, torch.Tensor]:
    """The port's parameter tree → an HF state_dict of tensors (views where
    a transpose suffices, on the tree's device). Families: "llama",
    "mistral", "gpt2", "bloom", "mixtral"."""
    p, L = params, cfg.num_layers
    out: Dict[str, torch.Tensor] = {}
    if family in ("llama", "mistral"):
        _export_llama_trunk(out, p, cfg, L)
        ml = p["layers"]["mlp"]
        for i in range(L):
            pre = f"model.layers.{i}."
            out[pre + "mlp.gate_proj.weight"] = ml["wg"][i].T
            out[pre + "mlp.up_proj.weight"] = ml["wi"][i].T
            out[pre + "mlp.down_proj.weight"] = ml["wo"][i].T
        return out
    if family == "gpt2":
        out["transformer.wte.weight"] = p["embed"]["tok"]
        out["transformer.wpe.weight"] = p["embed"]["pos"]
        out["transformer.ln_f.weight"] = p["final_norm"]["scale"]
        out["transformer.ln_f.bias"] = p["final_norm"]["bias"]
        at, ml = p["layers"]["attn"], p["layers"]["mlp"]
        for i in range(L):
            pre = f"transformer.h.{i}."
            out[pre + "ln_1.weight"] = p["layers"]["ln1"]["scale"][i]
            out[pre + "ln_1.bias"] = p["layers"]["ln1"]["bias"][i]
            out[pre + "ln_2.weight"] = p["layers"]["ln2"]["scale"][i]
            out[pre + "ln_2.bias"] = p["layers"]["ln2"]["bias"][i]
            out[pre + "attn.c_attn.weight"] = torch.cat(
                [at["wq"][i], at["wk"][i], at["wv"][i]], dim=1)
            out[pre + "attn.c_attn.bias"] = torch.cat([at["bq"][i], at["bk"][i], at["bv"][i]])
            out[pre + "attn.c_proj.weight"] = at["wo"][i]
            out[pre + "attn.c_proj.bias"] = at["bo"][i]
            out[pre + "mlp.c_fc.weight"] = ml["wi"][i]
            out[pre + "mlp.c_fc.bias"] = ml["bi"][i]
            out[pre + "mlp.c_proj.weight"] = ml["wo"][i]
            out[pre + "mlp.c_proj.bias"] = ml["bo"][i]
        return out
    if family == "bloom":
        nh, hd, d = cfg.num_heads, cfg.hd, cfg.hidden_size
        out["transformer.word_embeddings.weight"] = p["embed"]["tok"]
        out["transformer.word_embeddings_layernorm.weight"] = p["embed_norm"]["scale"]
        out["transformer.word_embeddings_layernorm.bias"] = p["embed_norm"]["bias"]
        out["transformer.ln_f.weight"] = p["final_norm"]["scale"]
        out["transformer.ln_f.bias"] = p["final_norm"]["bias"]
        at, ml = p["layers"]["attn"], p["layers"]["mlp"]
        for i in range(L):
            pre = f"transformer.h.{i}."
            out[pre + "input_layernorm.weight"] = p["layers"]["ln1"]["scale"][i]
            out[pre + "input_layernorm.bias"] = p["layers"]["ln1"]["bias"][i]
            out[pre + "post_attention_layernorm.weight"] = p["layers"]["ln2"]["scale"][i]
            out[pre + "post_attention_layernorm.bias"] = p["layers"]["ln2"]["bias"][i]
            # q/k/v re-interleaved into bloom's fused [H, 3, hd, d] layout
            w3 = torch.stack([at[k][i].T.reshape(nh, hd, d) for k in ("wq", "wk", "wv")],
                             dim=1)
            b3 = torch.stack([at[k][i].reshape(nh, hd) for k in ("bq", "bk", "bv")], dim=1)
            out[pre + "self_attention.query_key_value.weight"] = w3.reshape(3 * nh * hd, d)
            out[pre + "self_attention.query_key_value.bias"] = b3.reshape(3 * nh * hd)
            out[pre + "self_attention.dense.weight"] = at["wo"][i].T
            out[pre + "self_attention.dense.bias"] = at["bo"][i]
            out[pre + "mlp.dense_h_to_4h.weight"] = ml["wi"][i].T
            out[pre + "mlp.dense_h_to_4h.bias"] = ml["bi"][i]
            out[pre + "mlp.dense_4h_to_h.weight"] = ml["wo"][i].T
            out[pre + "mlp.dense_4h_to_h.bias"] = ml["bo"][i]
        return out
    if family == "mixtral":
        _export_llama_trunk(out, p, cfg, L)
        ml = p["layers"]["mlp"]
        expert_keys = (("w1", "wg"), ("w3", "wi"), ("w2", "wo"))  # gate, up, down
        for i in range(L):
            pre = f"model.layers.{i}."
            out[pre + "block_sparse_moe.gate.weight"] = ml["router"][i].T
            for hf_name, ours in expert_keys:
                for e in range(cfg.num_experts):
                    out[pre + f"block_sparse_moe.experts.{e}.{hf_name}.weight"] = \
                        ml[ours][i, e].T
        return out
    raise ValueError(f"export unsupported for family {family!r} (have "
                     f"llama/mistral/gpt2/bloom/mixtral)")


_ST_CODES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def _st_host(t, code: str) -> np.ndarray:
    """A tensor (any device) or array → the host array whose bytes the file
    holds under ``code``: a bf16 tensor as its uint16 view, a dtype
    safetensors lacks as fp32."""
    if isinstance(t, torch.Tensor):
        t = t.detach().contiguous().cpu()
        t = (t.view(torch.uint16) if code == "BF16" else t).numpy()
    arr = np.asarray(t, order="C")
    return arr if code == "BF16" else arr.astype(_ST_DTYPES[code], copy=False)


def _st_code(t) -> str:
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return "BF16"
        return _ST_CODES.get(numpy_dtype(t.dtype), "F32")
    return _ST_CODES.get(np.asarray(t).dtype, "F32")


def write_safetensors(path: str, tensors: Dict[str, Any]) -> None:
    """Write {name: tensor or numpy array} in the safetensors layout (a bf16
    tensor as BF16; a dtype safetensors lacks as F32). The header comes from
    the shapes alone; then each tensor goes to the host and out in turn, so
    the host holds one tensor at a time."""
    header: Dict[str, Any] = {}
    offset = 0
    for name, t in tensors.items():
        code = _st_code(t)
        n = int(np.prod(t.shape, dtype=np.int64)) * (2 if code == "BF16" else
                                                      np.dtype(_ST_DTYPES[code]).itemsize)
        header[name] = {"dtype": code, "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for name, t in tensors.items():
            f.write(_st_host(t, header[name]["dtype"]).tobytes())


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """One .safetensors file → {name: numpy array} (BF16 → fp32, exactly)."""
    out = {}
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        base = 8 + hlen
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            start, end = meta["data_offsets"]
            f.seek(base + start)
            raw = f.read(end - start)
            if meta["dtype"] == "BF16":
                arr = (np.frombuffer(raw, np.uint16).astype(np.uint32) << 16).view(np.float32)
            else:
                arr = np.frombuffer(raw, _ST_DTYPES[meta["dtype"]])
            out[name] = arr.reshape(tuple(meta["shape"]))
    return out
