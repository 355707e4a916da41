"""Flash attention's masked forms: the port's plain versions (what the CUDA
kernels compute with segment ids, a dense bias and a block-sparse layout) and
its autograd path through the attention registry, on the CPU, against the JAX
package's Pallas flash attention and ``sparse_attention`` in interpret mode.

B=2, H=4, KV=2 (GQA), D=64, fp32; S=256 (two 128-row tiles) for the segment
and bias forms, S=512 for the sparse layouts at block 128. Segment ids change
inside a tile. The sparse cases run the custom-VJP function that
``sparse_attention`` reaches, with the compaction tables as operands, so one
compile serves every mode; one case equals the public ``sparse_attention``
bit for bit. The forms: segment ids, causal and not; each of the four bias
shapes with its gradient (a full bias from the dq kernel's ``emit_dbias``, a
broadcast one from ``_bias_grad_kernel``); a bias with segments; ALiBi with
segments; all five sparsity modes, causal and not, with and without segment
ids, with windows and globals small enough that no layout at S=512 but the
dense one is dense. Tolerances: 2e-5 absolute on out and lse, 1e-4 of the
largest value on the gradients (fp32 sums in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import sparse_attention as psa
from deepspeed_tpu_torch.ops.attention import attention, attention_impl
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

B, H, KV, D = 2, 4, 2, 64
TOL, GRAD_TOL = 2e-5, 1e-4
BIAS_SHAPES = {"full": (B, H), "heads": (1, H), "batch": (B, 1), "shared": (1, 1)}
MODES = ("dense", "fixed", "bigbird", "bslongformer", "variable")


def _sparsity(mod, mode):
    """A small-window config of ``mode`` in module ``mod`` (either package)."""
    return {
        "dense": lambda: mod.DenseSparsityConfig(block=128),
        "fixed": lambda: mod.FixedSparsityConfig(block=128, num_local_blocks=2,
                                                 num_global_blocks=1),
        "bigbird": lambda: mod.BigBirdSparsityConfig(
            block=128, num_sliding_window_blocks=1, num_global_blocks=1,
            num_random_blocks=1, seed=3),
        "bslongformer": lambda: mod.BSLongformerSparsityConfig(
            block=128, num_sliding_window_blocks=1, global_block_indices=[2]),
        "variable": lambda: mod.VariableSparsityConfig(
            block=128, num_random_blocks=1, local_window_blocks=[1, 2],
            global_block_indices=[0], seed=5),
    }[mode]()


def _inputs(S):
    r = np.random.RandomState(S)
    return [r.randn(*shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D))]


def _segments(S):
    """[B, S] int32: boundaries inside 128-row tiles (50, 150; 135)."""
    seg = np.zeros((B, S), np.int32)
    seg[0, 50:150], seg[0, 150:] = 1, 2
    seg[1, 135:] = 1
    return seg


def _bias(shape, S):
    return 0.5 * np.random.RandomState(7).randn(*shape, S, S).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax(S, causal, seg, bias, alibi, mode):
    """(out, lse, dq, dk, dv[, dbias]) of the Pallas kernels in interpret
    mode, fp32 numpy; ``bias`` a key of BIAS_SHAPES or None, ``mode`` a
    sparsity mode or None."""
    q, k, v, do = _inputs(S)
    segs = jnp.asarray(_segments(S)) if seg else None
    b = jnp.asarray(_bias(BIAS_SHAPES[bias], S)) if bias else None
    slopes = jnp.asarray(jax_alibi_slopes(H)) if alibi else None
    tables = None
    if mode:
        cfg = _sparsity(jsa, mode)
        layout = cfg.make_layout(S)
        layout = jsa.causal_trim(layout) if causal else layout
        tables = tuple(jnp.asarray(t) for t in jfa._compact_rows(layout))

    def f(q, k, v, b):
        if mode:
            return jsa.sparse_attention(q, k, v, cfg, causal=causal, segment_ids=segs,
                                        alibi_slopes=slopes, interpret=True)
        return jfa.flash_attention(q, k, v, causal=causal, bias=b, segment_ids=segs,
                                   alibi_slopes=slopes, block_q=128, block_k=128,
                                   interpret=True)

    @jax.jit
    def run(q, k, v, b, do):
        out, vjp = jax.vjp(f, q, k, v, b)
        sw = lambda t: jnp.swapaxes(t, 1, 2)  # noqa: E731
        _, lse = jfa._flash_fwd(sw(q), sw(k), sw(v), b, segs, slopes, tables,
                                causal=causal, scale=1.0 / D ** 0.5, block_q=128,
                                block_k=128, interpret=True)
        return (out, lse[..., 0], *vjp(do))

    res = run(*(jnp.asarray(a) for a in (q, k, v)), b, jnp.asarray(do))
    return [np.asarray(t) for t in res if t is not None]


def _padded_tables(layout):
    """The Pallas entry's compaction tables of ``layout`` (``_compact_rows``,
    fwd and transposed), each row padded to the layout's width by repeating
    its last index, as ``_compact_rows`` pads a short row: every layout of a
    size then has tables of one shape, so one compile serves them all."""
    n = layout.shape[0]

    def pad(idx):
        return np.concatenate([idx, np.repeat(idx[:, -1:], n - idx.shape[1], axis=1)], 1)

    kcols, kcounts = jfa._compact_rows(layout)
    qrows, qcounts = jfa._compact_rows(layout.T)
    return tuple(jnp.asarray(a) for a in (pad(kcols), kcounts, pad(kcols), kcounts,
                                          pad(qrows), qcounts))


@functools.partial(jax.jit, static_argnums=(6,))
def _sparse_run(q, k, v, do, segs, tables, causal):
    """(out, lse, dq, dk, dv) of the Pallas kernels' block-sparse path: the
    custom-VJP function ``sparse_attention`` reaches through
    ``flash_attention(block_mask=...)``, with the tables as operands."""
    sw = lambda t: jnp.swapaxes(t, 1, 2)  # noqa: E731
    kw = dict(causal=causal, scale=1.0 / D ** 0.5, block_q=128, block_k=128,
              interpret=True)

    def f(q, k, v):
        return sw(jfa._flash_attention_bhsd(
            sw(q), sw(k), sw(v), None, segs, None, tables, kw["causal"], kw["scale"],
            128, 128, 128, 128, True))

    out, vjp = jax.vjp(f, q, k, v)
    _, lse = jfa._flash_fwd(sw(q), sw(k), sw(v), None, segs, None, tables[:2], **kw)
    return (out, lse[..., 0], *vjp(do))


@functools.lru_cache(maxsize=None)
def _jax_sparse(causal, seg, mode):
    """``_jax``'s outputs for a sparsity mode at S=512, one compile per
    (causal, seg) for all five modes."""
    layout = _sparsity(jsa, mode).make_layout(512)
    layout = jsa.causal_trim(layout) if causal else layout
    q, k, v, do = (jnp.asarray(a) for a in _inputs(512))
    segs = jnp.asarray(_segments(512)) if seg else None
    return [np.asarray(t) for t in _sparse_run(q, k, v, do, segs,
                                               _padded_tables(layout), causal)]


def _port_plain(S, causal, seg, bias, alibi, mode):
    """The same through the port's plain forward and backward."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(S))
    kw = {"segment_ids": torch.from_numpy(_segments(S)) if seg else None,
          "bias": torch.from_numpy(_bias(BIAS_SHAPES[bias], S)) if bias else None,
          "layout": psa.sparse_layout(_sparsity(psa, mode), S, causal) if mode else None}
    slopes = alibi_slopes(H) if alibi else None
    out, lse = fa.flash_attention_plain(q, k, v, causal, slopes, **kw)
    grads = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal, slopes, **kw,
                                         bias_grad=bias is not None)
    return [t.numpy() for t in (out, lse, *grads)]


def _close(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        tol = TOL if i < 2 else GRAD_TOL * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"output {i}")


@pytest.mark.parametrize("causal", [True, False])
def test_segment_ids_match_pallas(causal):
    _close(_port_plain(256, causal, True, None, False, None),
           _jax(256, causal, True, None, False, None))


@pytest.mark.parametrize("bias", sorted(BIAS_SHAPES))
def test_bias_and_its_gradient_match_pallas(bias):
    """Each bias shape through the plain versions, and through the registry's
    flash implementation (FlashAttentionFunction routes a full bias's
    gradient to the dq kernel, a broadcast one to the bias-gradient kernel),
    whose bias gradient autograd asks for."""
    want = _jax(256, True, False, bias, False, None)
    _close(_port_plain(256, True, False, bias, False, None), want)
    q, k, v, do = (torch.from_numpy(a).requires_grad_(True) for a in _inputs(256))
    b = torch.from_numpy(_bias(BIAS_SHAPES[bias], 256)).requires_grad_(True)
    with attention_impl("flash"):
        out = attention(q, k, v, causal=True, bias=b)
    out.backward(do.detach())
    got = [out.detach(), q.grad, k.grad, v.grad, b.grad]
    for g, w in zip(got, [want[0]] + want[2:]):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL * np.abs(w).max(), rtol=0)


def test_bias_with_segments_matches_pallas():
    _close(_port_plain(256, True, True, "full", False, None),
           _jax(256, True, True, "full", False, None))


def test_alibi_with_segments_matches_pallas():
    _close(_port_plain(256, True, True, None, True, None),
           _jax(256, True, True, None, True, None))


@pytest.mark.parametrize("seg", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_sparse_modes_match_pallas(mode, causal, seg):
    layout = psa.sparse_layout(_sparsity(psa, mode), 512, causal)
    if mode != "dense":
        full = np.tril(np.ones_like(layout)) if causal else np.ones_like(layout)
        assert (layout != full).any(), f"{mode} layout is dense at S=512"
    got = _port_plain(512, causal, seg, None, False, mode)
    _close(got, _jax_sparse(causal, seg, mode))
    if not seg:
        q, k, v, _ = _inputs(512)
        want = jsa.dense_blocksparse_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                               layout, 128, causal=causal)
        np.testing.assert_allclose(got[0], np.asarray(want), atol=TOL, rtol=0)
        mine = psa.dense_blocksparse_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                               layout, 128, causal=causal)
        np.testing.assert_allclose(mine.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_sparse_reference_is_the_public_entry():
    """The shared-compile reference above equals the JAX package's public
    ``sparse_attention`` (interpret mode), which builds its own tables."""
    for got, want in zip(_jax_sparse(True, True, "bigbird"),
                         _jax(512, True, True, None, False, "bigbird")):
        np.testing.assert_array_equal(got, want)


def test_compaction_tables_match_pallas():
    """The port's host-side tables (per query row, and transposed for the
    dk/dv kernel) equal the Pallas entry's ``_compact_rows``."""
    for mode in MODES:
        layout = psa.sparse_layout(_sparsity(psa, mode), 1024, True)
        for lay in (layout, layout.T):
            for got, want in zip(fa.compact_rows(lay), jfa._compact_rows(lay)):
                np.testing.assert_array_equal(got, want)
        tabs = fa.block_tables(layout, "cpu")
        assert tabs is fa.block_tables(layout.copy(), "cpu")  # made once per layout
        assert all(t.dtype == torch.int32 for t in tabs)


def test_flash_entry_refuses_what_the_kernels_do_not_take():
    """A bias not [B|1, H|1, S, S] raises (the JAX entry falls back to XLA);
    a layout whose block is not a multiple of 128 raises, as does a dense bias
    with a layout."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(256))
    with attention_impl("flash"), pytest.raises(ValueError, match="dense bias shape"):
        attention(q, k, v, bias=torch.zeros(256, 256))
    with pytest.raises(ValueError, match="multiple of 128"):
        fa.flash_attention_fwd(q, k, v, layout=np.ones((4, 4), np.int32))
    meta = torch.empty(2, 256, 4, 64, device="meta")
    with pytest.raises(ValueError):
        fa.mask_array("fwd", meta, bias=torch.zeros(1, 1, 256, 256, device="meta"),
                      layout=np.ones((2, 2), np.int32))
