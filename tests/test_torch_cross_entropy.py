"""Vocab-chunked cross-entropy: the port's autograd Function against the JAX
package's ``chunked_masked_ce`` (custom VJP), with a ragged vocab tail
(V=300, chunk 128) and ignored labels, fp32: loss rtol 1e-6 (measured
equal), grads atol 1e-6 (measured at most 5.6e-9); and against the port's
dense ``masked_ce``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepspeed_tpu.ops.cross_entropy import chunked_masked_ce as jax_chunked_ce
from deepspeed_tpu_torch.models.transformer import masked_ce
from deepspeed_tpu_torch.ops.cross_entropy import chunked_masked_ce

V, D, CHUNK = 300, 32, 128


def _inputs(seed=0):
    r = np.random.RandomState(seed)
    y = r.randn(2, 24, D).astype(np.float32)
    head = (0.3 * r.randn(D, V)).astype(np.float32)
    labels = r.randint(0, V, size=(2, 24))
    labels[0, :5] = -100
    labels[1, -3:] = -1
    labels[1, 0] = V - 1  # in the ragged tail
    return y, head, labels


def test_loss_and_grads_match_jax():
    y, head, labels = _inputs()
    (want, want_n), vjp = jax.vjp(
        lambda y, h: jax_chunked_ce(y, h, jnp.asarray(labels), CHUNK),
        jnp.asarray(y), jnp.asarray(head))
    want_dy, want_dh = vjp((jnp.float32(1.0), jnp.float32(0.0)))
    yt, ht = (torch.from_numpy(a).requires_grad_(True) for a in (y, head))
    ce, n = chunked_masked_ce(yt, ht, torch.from_numpy(labels), CHUNK)
    ce.backward()
    assert float(n) == float(want_n) == 40.0
    np.testing.assert_allclose(ce.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(want_dy), atol=1e-6)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_dh), atol=1e-6)


def test_matches_dense_masked_ce():
    y, head, labels = _inputs(seed=1)
    yt, ht = (torch.from_numpy(a).requires_grad_(True) for a in (y, head))
    ce, _ = chunked_masked_ce(yt, ht, torch.from_numpy(labels), CHUNK)
    ce.backward()
    y2, h2 = (torch.from_numpy(a).requires_grad_(True) for a in (y, head))
    dense, _ = masked_ce(y2 @ h2, torch.from_numpy(labels))
    dense.backward()
    np.testing.assert_allclose(ce.item(), dense.item(), rtol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), y2.grad.numpy(), atol=1e-6)
    np.testing.assert_allclose(ht.grad.numpy(), h2.grad.numpy(), atol=1e-6)
