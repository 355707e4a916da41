"""Block-sparse attention's host side: the port's sparsity configs against the
JAX package's. Every mode's layout equals JAX's ``make_layout`` (the random
blocks included) over several sequence lengths and settings, ``causal_trim``
equals, ``from_ds_config`` builds the same config from the same
"sparse_attention" section, and the config errors (an unknown mode, sparse
attention with sequence parallelism or with random-LTD) are the same
``DeepSpeedConfigError`` texts."""

import dataclasses

import numpy as np
import pytest

from deepspeed_tpu import config as jax_config
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch import config as port_config
from deepspeed_tpu_torch.ops import sparse_attention as psa

SETTINGS = {
    "dense": [{}],
    "fixed": [{}, {"num_local_blocks": 2, "num_global_blocks": 1},
              {"num_local_blocks": 3, "num_global_blocks": 2}],
    "bigbird": [{}, {"num_sliding_window_blocks": 5, "num_global_blocks": 2,
                     "num_random_blocks": 3, "seed": 7}],
    "bslongformer": [{}, {"num_sliding_window_blocks": 1, "global_block_indices": [1, 5, 40]}],
    "variable": [{}, {"num_random_blocks": 2, "local_window_blocks": [1, 3, 2],
                      "global_block_indices": [0, 9], "seed": 3}],
}
CLASSES = {"dense": "DenseSparsityConfig", "fixed": "FixedSparsityConfig",
           "bigbird": "BigBirdSparsityConfig", "bslongformer": "BSLongformerSparsityConfig",
           "variable": "VariableSparsityConfig"}


@pytest.mark.parametrize("mode", sorted(SETTINGS))
def test_layouts_equal_jax(mode):
    for kw in SETTINGS[mode]:
        for block, S in ((128, 128), (128, 1024), (128, 2048), (256, 4096), (64, 640)):
            want = getattr(jsa, CLASSES[mode])(block=block, **kw).make_layout(S)
            got = getattr(psa, CLASSES[mode])(block=block, **kw).make_layout(S)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(psa.causal_trim(got), jsa.causal_trim(want))
    with pytest.raises(ValueError, match="not divisible"):
        getattr(psa, CLASSES[mode])(block=128).make_layout(200)


def test_sparse_layout_is_made_once_and_trimmed():
    cfg = psa.BigBirdSparsityConfig(block=128, num_random_blocks=2)
    lay = psa.sparse_layout(cfg, 1024, True)
    assert lay is psa.sparse_layout(psa.BigBirdSparsityConfig(block=128, num_random_blocks=2),
                                    1024, True)
    np.testing.assert_array_equal(lay, jsa.causal_trim(cfg.make_layout(1024)))
    np.testing.assert_array_equal(psa.sparse_layout(cfg, 1024, False), cfg.make_layout(1024))


SECTIONS = [
    {"mode": "none"},
    {"mode": "dense", "block": 256},
    {"mode": "fixed", "block": 128, "num_local_blocks": 4, "num_global_blocks": 1},
    {"mode": "bigbird", "num_sliding_window_blocks": 5, "num_random_blocks": 2},
    {"mode": "bslongformer", "global_block_indices": [0, 3]},
    {"mode": "variable", "num_local_blocks": 2, "num_random_blocks": 1},
]


@pytest.mark.parametrize("section", SECTIONS, ids=[s["mode"] for s in SECTIONS])
def test_from_ds_config_equals_jax(section):
    raw = {"train_batch_size": 8, "sparse_attention": section}
    jcfg = jax_config.DeepSpeedConfig(dict(raw)).sparse_attention
    pcfg = port_config.DeepSpeedConfig(dict(raw)).sparse_attention
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    want, got = jsa.from_ds_config(jcfg), psa.from_ds_config(pcfg)
    if want is None:
        assert got is None
        return
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    np.testing.assert_array_equal(got.make_layout(2048), want.make_layout(2048))


@pytest.mark.parametrize("raw", [
    {"sparse_attention": {"mode": "sliding"}},
    {"sparse_attention": {"mode": "fixed"}, "sequence_parallel": {"sp_size": 2}},
    {"sparse_attention": {"mode": "bigbird"}, "sequence_parallel_size": 4},
    {"sparse_attention": {"mode": "fixed"},
     "data_efficiency": {"data_routing": {"random_ltd": {"enabled": True}}}},
], ids=["unknown-mode", "sp", "sp-size", "random-ltd"])
def test_config_errors_equal_jax(raw):
    raw = {"train_batch_size": 8, **raw}
    with pytest.raises(jax_config.DeepSpeedConfigError) as want:
        jax_config.DeepSpeedConfig(dict(raw))
    with pytest.raises(port_config.DeepSpeedConfigError) as got:
        port_config.DeepSpeedConfig(dict(raw))
    assert str(got.value) == str(want.value)
