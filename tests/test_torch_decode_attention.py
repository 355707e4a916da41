"""Decode attention: the port's plain version (what the CUDA kernel computes)
against the JAX package's Pallas decode kernel in interpret mode, with a
scalar and a per-row [B] cache_len, Smax=256, GQA, atol 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.decode_attention import decode_attention_kernel
from deepspeed_tpu_torch.ops.cuda.decode_attention import (
    cached_attention_plain, decode_attention, decode_attention_plain)

B, SMAX, H, KV, HD = 2, 256, 4, 2, 64


def _inputs(seed=0):
    r = np.random.RandomState(seed)
    q = r.randn(B, 1, H, HD).astype(np.float32)
    kc = r.randn(B, SMAX, KV, HD).astype(np.float32)
    vc = r.randn(B, SMAX, KV, HD).astype(np.float32)
    return q, kc, vc


def _pallas(q, kc, vc, cache_len):
    return np.asarray(decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(cache_len, jnp.int32), interpret=True,
    ))


@pytest.mark.parametrize("cache_len", [0, 5, 130, 255])
def test_scalar_frontier_matches_pallas(cache_len):
    q, kc, vc = _inputs()
    got = decode_attention(*map(torch.from_numpy, (q, kc, vc)), cache_len)
    np.testing.assert_allclose(got.numpy(), _pallas(q, kc, vc, cache_len),
                               atol=2e-5)


@pytest.mark.parametrize("frontier", [[3, 200], [255, 0]])
def test_per_row_frontier_matches_pallas(frontier):
    q, kc, vc = _inputs(seed=1)
    cl = torch.tensor(frontier, dtype=torch.int32)
    got = decode_attention(*map(torch.from_numpy, (q, kc, vc)), cl)
    np.testing.assert_allclose(got.numpy(),
                               _pallas(q, kc, vc, np.asarray(frontier)),
                               atol=2e-5)


def test_reads_a_cache_layer_view():
    """The wrapper takes one layer of the [L, B, Smax, KV, hd] cache as a
    view, as the decode loop passes it."""
    q, kc, vc = _inputs(seed=2)
    kall = torch.stack([torch.zeros(B, SMAX, KV, HD), torch.from_numpy(kc)])
    vall = torch.stack([torch.zeros(B, SMAX, KV, HD), torch.from_numpy(vc)])
    got = decode_attention(torch.from_numpy(q), kall[1], vall[1], 77)
    np.testing.assert_allclose(got.numpy(), _pallas(q, kc, vc, 77), atol=2e-5)


def test_plain_is_single_token_and_multi_token_generalises():
    q, kc, vc = map(torch.from_numpy, _inputs(seed=3))
    with pytest.raises(ValueError):
        decode_attention_plain(q.expand(B, 2, H, HD), kc, vc, 4)
    # two new tokens at positions 9 and 10 equal two single-token calls
    q2 = torch.cat([q, q.flip(0)], dim=1)
    both = cached_attention_plain(q2, kc, vc, 9)
    torch.testing.assert_close(both[:, :1], decode_attention_plain(q, kc, vc, 9),
                               atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(both[:, 1:],
                               decode_attention_plain(q.flip(0), kc, vc, 10),
                               atol=1e-6, rtol=1e-5)
