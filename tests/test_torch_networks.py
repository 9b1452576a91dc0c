"""The weight importer and ``PolicyNet`` against flax.

- the pure-Python msgpack decoder against ``flax.serialization`` on the
  shipped artifact, leaf for leaf (exact);
- raw parameter heads and selector logits against the flax ``PolicyNet``
  on a random-init ``test`` state and on the shipped artifact at full
  width, with dropout keep 1.0 on both sides (JAX and torch draw
  different random bits; flax ``Dropout(rate=0)`` is the identity).
  Tolerance 1e-5: f32 convolutions and 4096-d products summed in another
  order;
- the traps in carrying the network over: flatten order, SAME padding,
  dropout on at serving, head width.
"""

import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from exposure_tpu.models.networks import PolicyNet as JPolicyNet
from exposure_tpu.utils import load_config as j_load_config
from exposure_tpu_torch.core.artifacts import (
    flax_to_state_dict,
    load_artifact,
    msgpack_restore,
)
from exposure_tpu_torch.models.networks import (
    FeatureExtractor,
    build_policy,
    dropout,
)
from exposure_tpu_torch.ops.filters import build_filters
from exposure_tpu_torch.utils.config import load_config as t_load_config
from exposure_tpu_torch.utils.ops import lrelu

ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        'artifacts', 'serving',
                        'synthetic_explore--best.msgpack.gz')
TOL = 1e-5


def _leaves(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + '/')
        else:
            yield prefix + k, v


@pytest.fixture(scope='module')
def artifact_bytes():
    with gzip.open(ARTIFACT, 'rb') as f:
        return f.read()


def test_msgpack_decoder_matches_flax(artifact_bytes):
    want = serialization.msgpack_restore(artifact_bytes)
    got = msgpack_restore(artifact_bytes)
    assert {k: v for k, v in got.items() if k != 'gen_params'} == \
        {k: v for k, v in want.items() if k != 'gen_params'}
    got_leaves = dict(_leaves(got['gen_params']))
    want_leaves = dict(_leaves(want['gen_params']))
    assert sorted(got_leaves) == sorted(want_leaves)
    for name, w in want_leaves.items():
        g = got_leaves[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_msgpack_decoder_scalars_and_small_types():
    payload = {'a': np.float32(1.5), 'b': np.arange(6, dtype=np.int32)
               .reshape(2, 3), 'c': [1, -3, 300, -70000, 2 ** 40],
               'd': 'x' * 40, 'e': None, 'f': True, 'g': 0.25}
    got = msgpack_restore(serialization.msgpack_serialize(payload))
    want = serialization.msgpack_restore(
        serialization.msgpack_serialize(payload))
    assert got['a'] == want['a'] and type(got['a']) is type(want['a'])
    np.testing.assert_array_equal(got['b'], want['b'])
    for key in 'cdefg':
        assert got[key] == want[key], key


def _j_policy(cfg):
    filters = [f(cfg) for f in cfg.filters]
    return JPolicyNet(
        filter_output_dims=tuple(
            f.get_num_filter_parameters() + f.get_num_mask_parameters()
            for f in filters),
        feature_extractor_dims=cfg.feature_extractor_dims,
        base_channels=cfg.base_channels, fc1_size=cfg.fc1_size,
        dropout_keep_prob=cfg.dropout_keep_prob)


def _compare(config_name, gen_params, rng, batch=2):
    jcfg = j_load_config(config_name).copy()
    jcfg.dropout_keep_prob = 1.0
    tcfg = t_load_config(config_name)
    tcfg.dropout_keep_prob = 1.0
    x = rng.rand(batch, 64, 64, 3 + jcfg.num_state_dim).astype(np.float32)
    j_raw, j_logits = _j_policy(jcfg).apply(
        gen_params, jnp.asarray(x), rngs={'dropout': jax.random.PRNGKey(0)})
    policy = build_policy(tcfg, build_filters(tcfg))
    policy.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, gen_params)))
    with torch.no_grad():
        t_raw, t_logits = policy(torch.from_numpy(x))
    assert len(t_raw) == len(j_raw)
    for j, (a, b) in enumerate(zip(t_raw, j_raw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL, err_msg='head %d' % j)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=TOL, atol=TOL)


def test_policy_matches_flax_random_init(rng):
    cfg = j_load_config('test')
    key = jax.random.PRNGKey(0)
    gen_params = _j_policy(cfg).init(
        {'params': key, 'dropout': key},
        jnp.zeros((2, 64, 64, 3 + cfg.num_state_dim)))
    _compare('test', gen_params, rng, batch=3)


def test_policy_matches_flax_on_artifact(rng):
    gen_params = load_artifact(ARTIFACT)['gen_params']
    _compare('synthetic_explore',
             jax.tree_util.tree_map(jnp.asarray, gen_params), rng)


def test_flatten_order_is_nhwc():
    # flax flattens the final [B, 4, 4, C] map in NHWC order; a plain NCHW
    # flatten of the same map gives another vector
    fx = FeatureExtractor(1, 32, base_channels=4, dropout_keep_prob=1.0,
                          input_size=16)
    x = torch.rand(1, 16, 16, 1, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = fx(x)
        h = (x - 0.5).permute(0, 3, 1, 2)
        for conv in fx.convs:
            h = lrelu(conv(h))
    nhwc = h.permute(0, 2, 3, 1).reshape(1, -1)
    assert torch.equal(out, nhwc)
    assert not torch.equal(out, h.reshape(1, -1))


def test_odd_sizes_are_refused():
    fx = FeatureExtractor(3, 64, base_channels=4, input_size=18)
    with pytest.raises(ValueError):
        fx(torch.zeros(1, 18, 18, 3))   # 18 -> 9 is odd


def test_dropout_stays_on_at_serving():
    cfg = t_load_config('test')
    policy = build_policy(cfg, build_filters(cfg)).eval()
    x = torch.rand(2, 64, 64, 3 + cfg.num_state_dim)
    with torch.no_grad():
        a = policy(x, torch.Generator().manual_seed(1))[1]
        b = policy(x, torch.Generator().manual_seed(2))[1]
        c = policy(x, torch.Generator().manual_seed(1))[1]
    assert not torch.equal(a, b)      # eval() does not turn it off
    assert torch.equal(a, c)          # the generator decides the mask
    y = torch.ones(1000)
    kept = dropout(y, 0.5, torch.Generator().manual_seed(0))
    assert set(kept.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(dropout(y, 1.0, None), y)


def test_head_width_includes_mask_params_without_masking():
    cfg = t_load_config('synthetic_explore')
    assert not cfg.masking
    policy = build_policy(cfg, build_filters(cfg))
    assert policy.filter_output_dims == (7, 7, 9, 7, 14, 7, 7, 30)
