"""Ring attention and Ulysses in the port, on the CPU.

- The ring flash (``ops/ring_flash.py``: the flash kernels' offset form per
  hop, merged by logsumexp; here the kernels' plain versions) and the dense
  ring (``parallel/sequence.py:_ring_attention_local``), run through the
  one-process loopback ring at sp=2 and sp=4, against the JAX package's
  ``ring_attention`` on the 8-device CPU mesh under the flash
  implementation (Pallas ring flash in interpret mode), forward and the q,
  k, v gradients: causal with GQA, causal with ALiBi and segment ids that
  cross the chunk edges, and non-causal with segments. B=1, S=512, H=4,
  KV=2, D=64, fp32. Tolerances as ``tests/test_ring_flash.py``: 2e-5 on the
  output, 5e-4 on the gradients.
- Ulysses (the all-to-all pair; kv heads repeated when sp does not divide
  them) and the ring over a real sp process group (a spawned gloo world of
  4), each against the port's flat attention on the whole sequence, forward
  and gradients, at the same tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm.topology import MeshTopology, ParallelDims
from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.attention import attention_impl as jax_attention_impl
from deepspeed_tpu.parallel.sequence import ring_attention as jax_ring_attention
from deepspeed_tpu_torch.launcher import launch_local
from deepspeed_tpu_torch.ops.ring_flash import Ring, ring_flash_attention_local
from deepspeed_tpu_torch.parallel.sequence import _ring_attention_local, kv_repeats

from torch_sp_worker import attention_rank, flat_attention

B, S, H, D = 1, 512, 4, 64
OUT_TOL, GRAD_TOL = 2e-5, 5e-4
CASES = {  # (sp, causal, alibi, segments)
    "sp4 causal gqa": (4, True, False, False),
    "sp2 causal alibi segments": (2, True, True, True),
    "sp4 non-causal segments": (4, False, False, True),
}


def _case(seed, KV=2, causal=True, alibi=False, segments=False):
    r = np.random.RandomState(seed)
    c = {"q": r.randn(B, S, H, D).astype(np.float32),
         "k": r.randn(B, S, KV, D).astype(np.float32),
         "v": r.randn(B, S, KV, D).astype(np.float32),
         "g": r.randn(B, S, H, D).astype(np.float32), "causal": causal}
    if segments:  # boundaries inside chunks and on none of their edges
        c["segment_ids"] = np.repeat(np.arange(4, dtype=np.int32), [100, 200, 150, 62])[None]
    if alibi:
        c["slopes"] = np.asarray(jax_alibi_slopes(H), np.float32)
    return c


def _jax_ring(c, sp):
    topo = MeshTopology(dims=ParallelDims(sp=sp, dp=8 // sp))
    seg = None if "segment_ids" not in c else jnp.asarray(c["segment_ids"])
    slopes = None if "slopes" not in c else c["slopes"]

    def f(q, k, v):
        with jax_attention_impl("flash"):
            return jax_ring_attention(q, k, v, causal=c["causal"], segment_ids=seg,
                                      alibi_slopes=slopes, topo=topo)

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(g))

    return [np.asarray(t) for t in run(*(jnp.asarray(c[n]) for n in "qkvg"))]


def _port_ring(c, sp, flash: bool):
    q, k, v = (torch.from_numpy(c[n]).requires_grad_(True) for n in "qkv")
    ch = lambda t: list(t.split(S // sp, dim=1))  # noqa: E731
    seg = None if "segment_ids" not in c else ch(torch.from_numpy(c["segment_ids"]))
    slopes = None if "slopes" not in c else torch.from_numpy(c["slopes"])
    ring = Ring.loopback(sp)
    if flash:
        outs = ring_flash_attention_local(ch(q), ch(k), ch(v), seg, seg, slopes,
                                          causal=c["causal"], ring=ring)
    else:
        outs = _ring_attention_local(ring, ch(q), ch(k), ch(v), seg, seg, slopes,
                                     causal=c["causal"])
    out = torch.cat(outs, dim=1)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(c["g"]))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def _close(got, want, what):
    for n, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        tol = OUT_TOL if n == "out" else GRAD_TOL
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=f"{what} {n}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_loopback_rings_match_jax_ring_flash(name):
    sp, causal, alibi, segments = CASES[name]
    c = _case(sorted(CASES).index(name), causal=causal, alibi=alibi, segments=segments)
    want = _jax_ring(c, sp)
    _close(_port_ring(c, sp, flash=True), want, f"{name} ring flash")
    _close(_port_ring(c, sp, flash=False), want, f"{name} dense ring")


def test_kv_repeats():
    assert [kv_repeats(kv, 4) for kv in (1, 2, 4, 8, 6)] == [4, 2, 1, 1, 2]
    assert kv_repeats(8, 2) == 1 and kv_repeats(1, 2) == 2


def test_sp_attention_over_a_process_group_matches_flat():
    """A gloo world of 4 (sp=4): Ulysses with KV=2 (each kv head repeated
    twice) and with KV=4, with ALiBi and segments; the dense ring and the
    ring flash over the group. Each rank's output chunk and the ranks'
    summed gradients against the flat attention on the whole sequence."""
    sp = 4
    cases = []
    for label, mode, impl, KV in (("ulysses kv2", "ulysses", "plain", 2),
                                  ("ulysses kv4", "ulysses", "flash", 4),
                                  ("ring dense", "ring", "plain", 2),
                                  ("ring flash", "ring", "flash", 2)):
        c = _case(len(cases) + 10, KV=KV, alibi=True, segments=True)
        c.update(label=label, mode=mode, impl=impl)
        cases.append(c)
    ranks = launch_local(attention_rank, sp, (sp, cases), backend="gloo")
    for c in cases:
        want = flat_attention(c)
        parts = [r[c["label"]] for r in ranks]
        got = [np.concatenate([p[0] for p in parts], axis=1)] + \
            [sum(p[i] for p in parts) for i in (1, 2, 3)]
        _close(got, want, c["label"])
