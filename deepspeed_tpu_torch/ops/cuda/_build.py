"""Build the hand-written CUDA kernels and load them with ctypes.

Every ``deepspeed_tpu_torch/csrc/*.cu`` source is compiled for Hopper
(``sm_90a``) on first use, each by its own ``nvcc`` process, all started
together, then linked into one shared library with a plain C interface:
``build/torch_kernels/libdstorch.so`` at the root of the checkout. The library
is rebuilt when a source changes (a hash of the sources is kept beside it) and
loaded once per process. Nothing is built on import, and nothing outside the
checkout is read but the CUDA toolkit.

Each C entry point takes its pointers and the stream as ``void*`` and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero status, so a launch
the card refused is never mistaken for one that ran.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
LIB_NAME = "libdstorch.so"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's usual home
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_LP = ctypes.POINTER(ctypes.c_longlong)  # a strides array
# argtypes of every C entry point (pointers and the stream as c_void_p, so
# ctypes never cuts a 64-bit address to an int)
SIGNATURES: Dict[str, List] = {
    "dst_rmsnorm_fwd": [_P, _P, _P, _I, _I, _F, _I, _I, _P],
    "dst_rmsnorm_bwd_nblocks": [_I, _I, _I],
    "dst_rmsnorm_bwd": [_P] * 6 + [_I, _I, _F, _I, _I, _P],
    # the fp16 entries (rmsnorm, flash's Llama form) take the others' arguments
    # less the dtype codes
    "dst_rmsnorm_fwd_f16": [_P, _P, _P, _I, _I, _F, _P],
    "dst_rmsnorm_bwd_f16": [_P] * 6 + [_I, _I, _F, _P],
    "dst_layernorm_fwd": [_P] * 4 + [_I, _I, _F, _I, _I, _P],
    "dst_layernorm_bwd_nblocks": [_I, _I, _I],
    "dst_layernorm_bwd": [_P] * 7 + [_I, _I, _F, _I, _I, _P],
    # the attention entry points take their ALiBi slopes (or NULL) as the
    # pointer before the softmax scale; the flash ones their mask array (or
    # NULL) after the causal flag
    "dst_flash_attention_bwd_dq": [_P] * 8 + [_I] * 5 + [_LP, _P, _F, _I, _LP, _P],
    "dst_flash_attention_bwd_dkv": [_P] * 8 + [_I] * 5 + [_LP, _P, _F, _I, _LP, _P],
    "dst_flash_attention_bias_grad": [_P] * 6 + [_I] * 7 + [_LP, _P, _F, _I, _LP, _P],
    "dst_fused_adam": [_P] * 4 + [_L, _P] + [_F] * 9 + [_I, _P],
    "dst_flash_attention_fwd": (
        [_P] * 5 + [_I] * 5 + [_L] * 12 + [_P, _F, _I, _LP, _P]
    ),
    "dst_flash_attention_fwd_f16": (
        [_P] * 5 + [_I] * 5 + [_L] * 12 + [_P, _F, _I, _LP, _P]
    ),
    "dst_flash_attention_bwd_dq_f16": [_P] * 8 + [_I] * 5 + [_LP, _P, _F, _I, _LP, _P],
    "dst_flash_attention_bwd_dkv_f16": [_P] * 8 + [_I] * 5 + [_LP, _P, _F, _I, _LP, _P],
    "dst_decode_attention": (
        [_P] * 5 + [_I] * 7 + [_L] * 8 + [_P, _F, _I, _P]
    ),
    "dst_decode_attention_int8": (
        [_P] * 7 + [_I] * 7 + [_L] * 12 + [_P, _F, _I, _P]
    ),
    "dst_paged_decode_attention": (
        [_P] * 6 + [_I] * 7 + [_L] * 8 + [_P, _F, _I, _P]
    ),
    "dst_paged_decode_attention_int8": (
        [_P] * 8 + [_I] * 7 + [_L] * 12 + [_P, _F, _I, _P]
    ),
    "dst_quantized_expert_matvec": [_I] + [_P] * 5 + [_I] * 9 + [_P],
}

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError(
        "cannot build the deepspeed_tpu_torch CUDA kernels: nvcc not found "
        "(set CUDA_HOME or put nvcc on PATH)"
    )


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _compile(nvcc: str, digest: str) -> None:
    """One nvcc per source, all in flight at once, then one link."""
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    logs, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "ptxas.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(logs)
        )
    tmp = BUILD_DIR / f"{LIB_NAME}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    os.replace(tmp, BUILD_DIR / LIB_NAME)
    (BUILD_DIR / f"{LIB_NAME}.sha256").write_text(digest)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _source_hash()
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / f"{LIB_NAME}.sha256"
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build at a time per checkout
        if not (lib_path.exists() and stamp.exists()
                and stamp.read_text() == digest):
            _compile(nvcc, digest)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dst_error_string.argtypes = [ctypes.c_int]
    lib.dst_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if status != 0:
        msg = library().dst_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def strides_array(*tensors: torch.Tensor):
    """The (batch, seq, head) strides of each [B, S, H, D] tensor, in order,
    as the C array the flash kernels take."""
    vals = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def stream_handle(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream of t's device, without building
    a torch.cuda.Stream (the call torch's own generated kernel launchers
    make; a fraction of torch.cuda.current_stream(...).cuda_stream's host
    time)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


# where the fp16 forms of the other kernels come
FP16_LATER = ("ROADMAP A6 part 2 (fp16 LayerNorm, ALiBi, the masked and offset "
              "flash forms, the bias gradient, decode)")


def dtype_code(dtype, fp16: bool = False) -> int:
    """The dtype's code; float16 only for a kernel with an fp16 form
    (``fp16``), else the refusal names where those forms come."""
    if dtype == torch.float16 and not fp16:
        raise NotImplementedError(f"no fp16 form of this CUDA kernel: {FP16_LATER}")
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise ValueError(f"no CUDA kernel for dtype {dtype}") from None


def ptxas_log() -> str:
    """nvcc's -Xptxas -v report of the last build (registers, spills)."""
    path = BUILD_DIR / "ptxas.log"
    return path.read_text() if path.exists() else ""
