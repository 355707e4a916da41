"""The port's aio pool (``deepspeed_tpu_torch/ops/aio.py``, the C++ pool of
``csrc/aio/aio.cpp`` built into ``build/aio``) and its tensor swapper
(``runtime/swap_tensor.py``), byte for byte: the cases of
``tests/test_aio_autotuner.py`` (a write/read round trip, many requests in
flight, a missing file raising, the swapper's round trip, the generation
pool's rotation and its read-after-overwrite refusal) on CPU tensors, and a
swap directory the JAX package's ``TensorSwapper`` wrote, read by the
port's."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.swap_tensor import TensorSwapper as JaxTensorSwapper
from deepspeed_tpu_torch.ops import aio
from deepspeed_tpu_torch.runtime.swap_tensor import TensorSwapper


def test_library_builds_into_the_build_directory():
    aio.AsyncIOHandle(num_threads=1).close()
    assert aio.LIB_PATH.exists() and aio.LIB_PATH.parent.name == "aio"
    assert aio.LIB_PATH.parent.parent.name == "build"
    assert aio.LIB_PATH.parent != aio.SOURCE.parent


def test_aio_write_read_roundtrip(tmp_path):
    h = aio.AsyncIOHandle(num_threads=2)
    data = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(np.float32))
    path = str(tmp_path / "x.bin")
    h.wait(h.submit_write(path, data))
    assert os.path.getsize(path) == data.numel() * 4
    out = torch.empty_like(data)
    h.wait(h.submit_read(path, out))
    assert torch.equal(out, data)
    h.close()


def test_aio_many_concurrent(tmp_path):
    h = aio.AsyncIOHandle(num_threads=4)
    r = np.random.RandomState(1)
    arrays = [torch.from_numpy(r.randn(256 + i)) for i in range(20)]
    for i, a in enumerate(arrays):
        h.submit_write(str(tmp_path / f"f{i}.bin"), a)
    h.wait_all()
    outs = [torch.empty_like(a) for a in arrays]
    reqs = [h.submit_read(str(tmp_path / f"f{i}.bin"), o) for i, o in enumerate(outs)]
    for q in reqs:
        h.wait(q)
    assert all(torch.equal(a, o) for a, o in zip(arrays, outs))
    assert h.pending() == 0
    h.close()


def test_aio_read_missing_file_errors(tmp_path):
    h = aio.AsyncIOHandle(num_threads=1)
    with pytest.raises(OSError):
        h.wait(h.submit_read(str(tmp_path / "missing.bin"), torch.empty(16)))
    with pytest.raises(ValueError, match="contiguous CPU"):
        h.submit_write(str(tmp_path / "t.bin"), torch.empty(4, 4).t())
    h.close()


def test_tensor_swapper_roundtrip(tmp_path):
    sw = TensorSwapper(str(tmp_path), num_threads=2)
    tree = {"a": torch.arange(32, dtype=torch.float32).reshape(4, 8),
            "b": {"c": torch.ones(3, dtype=torch.int32)}}
    sw.swap_out("opt", tree, blocking=False)
    back = sw.swap_in("opt")  # waits for the writes first
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["b"]["c"], tree["b"]["c"])
    assert back["b"]["c"].dtype == torch.int32
    sw.release("opt")
    assert not any(f.endswith(".bin") for f in os.listdir(tmp_path))
    sw.close()


def test_tensor_swapper_generation_pool_rotation(tmp_path):
    """A read generation retires once its copies have landed, a write
    generation once its writes have; a buffer still referenced by an
    in-flight write is never handed back to the free pool."""
    sw = TensorSwapper(str(tmp_path), num_threads=1, reuse_buffers=True)
    tree = {"m": torch.arange(16, dtype=torch.float32)}
    sw.swap_out("opt", tree)
    assert sw.generation == 1  # the write landed: its buffers retired
    t1 = sw.swap_in("opt", device="cpu")
    assert sw.generation == 2
    t2 = sw.swap_in("opt", device="cpu")
    assert sw.generation == 3
    assert torch.equal(t1["m"], t2["m"]) and t1["m"].data_ptr() != t2["m"].data_ptr()
    sw.swap_in("opt")  # no device: fresh buffers, handed out, never rotated
    assert sw.generation == 3
    sw._pending["bogus"] = ([], list(sw._last_gen))
    with pytest.raises(RuntimeError, match="read-after-overwrite"):
        sw._retire_gen([])
    sw._pending.pop("bogus")
    sw.close()


def test_reads_a_swap_directory_the_jax_swapper_wrote(tmp_path):
    r = np.random.RandomState(2)
    tree = {"mu": {"w": r.randn(3, 5).astype(np.float32), "b": r.randn(5).astype(np.float32)},
            "count": np.asarray([7, 7], np.int32)}
    jsw = JaxTensorSwapper(str(tmp_path))
    jsw.swap_out("opt_state", {k: jnp.asarray(v) if not isinstance(v, dict)
                               else {kk: jnp.asarray(vv) for kk, vv in v.items()}
                               for k, v in tree.items()})
    jsw.close()
    sw = TensorSwapper(str(tmp_path))
    template = {"mu": {"w": None, "b": None}, "count": None}
    back = sw.swap_in("opt_state", template=template)
    np.testing.assert_array_equal(back["mu"]["w"].numpy(), tree["mu"]["w"])
    np.testing.assert_array_equal(back["mu"]["b"].numpy(), tree["mu"]["b"])
    np.testing.assert_array_equal(back["count"].numpy(), tree["count"])
    assert [t.dtype for t in sw.swap_in("opt_state")] == [torch.int32, torch.float32,
                                                          torch.float32]
    sw.close()
