"""The switch chain (K2), the static chain (K3) and the grouped runner of
the port against the JAX kernels, run in interpret mode as the JAX
package's own tests run them on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version, which
is what these tests exercise; the CUDA kernels are held to the same plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
Tolerances: f32 atol 3e-5 / rtol 1e-4 (5e-5 masked), u8 1 LSB, as
tests/test_pallas_chain.py; bf16 at its bound against the f32 result
(max 8 LSB, mean below 2).  Every runner route is identified through
``last_route`` and checked against the JAX switch kernel's output, which
the JAX runner reproduces (tests/test_pallas_chain.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exposure_tpu.ops.filters import max_filter_parameters
from exposure_tpu.ops.pallas_chain import (
    pallas_apply_filter_chain,
    pallas_apply_filter_chain_static,
)
from exposure_tpu.utils import load_config as j_load_config
from exposure_tpu_torch.ops.filters import build_filters
from exposure_tpu_torch.ops.grouped_chain import (
    GroupedChainRunner,
    bucket_size,
)
from exposure_tpu_torch.ops.static_chain import apply_filter_chain_static
from exposure_tpu_torch.ops.switch_chain import apply_filter_chain_switch
from exposure_tpu_torch.utils.config import load_config as t_load_config


def _banks(masking=False):
    jcfg, tcfg = j_load_config('test').copy(), t_load_config('test')
    jcfg.masking = tcfg.masking = masking
    return [f(jcfg) for f in jcfg.filters], build_filters(tcfg)


def _trajectory(rng, filters, k, b):
    """Random (ids, packed regressed params) like a rollout emits."""
    ids = rng.randint(0, len(filters), (k, b)).astype(np.int32)
    params = np.zeros((k, b, max_filter_parameters(filters)), np.float32)
    for s in range(k):
        for i in range(b):
            f = filters[ids[s, i]]
            raw = rng.randn(1, f.get_num_filter_parameters()).astype(
                np.float32)
            params[s, i, :raw.shape[1]] = np.asarray(
                f.filter_param_regressor(jnp.asarray(raw))).reshape(-1)
    return ids, params


def _image(rng, b, h, w, dtype):
    x = rng.rand(b, h, w, 3) * 0.9
    return (x * 255).astype(np.uint8) if dtype == 'uint8' \
        else x.astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _switch_jax(img, ids, params, jf, **kw):
    return np.asarray(pallas_apply_filter_chain(
        jnp.asarray(img), jnp.asarray(ids), jnp.asarray(params), jf,
        tile=(32, 128), interpret=True, **kw))


def _assert_match(got, want, atol=3e-5):
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.uint8:
        lsb = np.abs(got.astype(np.int32) - want.astype(np.int32)).max()
        assert lsb <= 1, 'u8 off by %d LSB' % lsb
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=1e-4)


# -- K2 plain version against pallas_apply_filter_chain ------------------

@pytest.mark.parametrize('fast', [False, True], ids=['exact', 'fast'])
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_switch_matches_jax(rng, fast, dtype):
    jf, tf = _banks()
    img = _image(rng, 2, 64, 128, dtype)
    ids, params = _trajectory(rng, jf, 5, 2)
    active = np.array([[1, 1], [1, 0], [0, 1], [1, 1], [0, 0]], np.float32)
    want = _switch_jax(img, ids, params, jf, active_steps=_j(active),
                       fast_math=fast)
    got = apply_filter_chain_switch(_t(img), _t(ids), _t(params), tf,
                                    active_steps=_t(active), fast_math=fast)
    _assert_match(got, want)


def test_switch_masked_matches_jax(rng):
    jf, tf = _banks(masking=True)
    img = _image(rng, 2, 96, 128, 'float32')
    ids, params = _trajectory(rng, jf, 3, 2)
    mask = rng.randn(3, 2, 6).astype(np.float32)
    want = _switch_jax(img, ids, params, jf, mask_params=_j(mask))
    got = apply_filter_chain_switch(_t(img), _t(ids), _t(params), tf,
                                    mask_params=_t(mask))
    _assert_match(got, want, atol=5e-5)


def test_switch_bf16_matches_jax(rng):
    """bf16 pixel math: the JAX kernel's bound against the f32 result
    (max 8 LSB, mean below 2), and the JAX bf16 kernel within 1 LSB."""
    jf, tf = _banks()
    img8 = _image(rng, 2, 64, 128, 'uint8')
    ids, params = _trajectory(rng, jf, 5, 2)
    f32 = _switch_jax(img8, ids, params, jf)
    j_bf16 = _switch_jax(img8, ids, params, jf, compute_dtype=jnp.bfloat16)
    got = apply_filter_chain_switch(_t(img8), _t(ids), _t(params), tf,
                                    compute_dtype=torch.bfloat16).numpy()
    diff = np.abs(got.astype(np.int32) - f32.astype(np.int32))
    assert diff.max() <= 8 and diff.mean() < 2.0, (diff.max(), diff.mean())
    _assert_match(got, j_bf16)


def test_switch_rows_scatter(rng):
    """``rows`` and ``n_active``: active slots write their own row of
    ``out`` with that row's ids and parameters; other rows stay."""
    jf, tf = _banks()
    img = _image(rng, 5, 32, 64, 'uint8')
    ids, params = _trajectory(rng, jf, 3, 5)
    want = _switch_jax(img, ids, params, jf)
    out = torch.zeros(img.shape, dtype=torch.uint8)
    rows = torch.tensor([3, 0, 4, 3], dtype=torch.int32)
    apply_filter_chain_switch(_t(img), _t(ids), _t(params), tf, rows=rows,
                              out=out, n_active=3)
    _assert_match(out[[0, 3, 4]], want[[0, 3, 4]])
    assert not out[[1, 2]].any()


# -- K3 plain version against pallas_apply_filter_chain_static -----------

@pytest.mark.parametrize('fast', [False, True], ids=['exact', 'fast'])
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_static_matches_jax(rng, fast, dtype):
    jf, tf = _banks()
    img = _image(rng, 3, 64, 128, dtype)
    sig = (0, 2, 1, len(jf), 3)        # with an identity step
    _, params = _trajectory(rng, jf, 5, 3)
    want = np.asarray(pallas_apply_filter_chain_static(
        jnp.asarray(img), sig, jnp.asarray(params), jf, tile=(32, 128),
        interpret=True, fast_math=fast, n_active=2))
    got = apply_filter_chain_static(_t(img), sig, _t(params), tf,
                                    fast_math=fast, n_active=2)
    _assert_match(got[:2], want[:2])   # rows past n_active: unspecified


def test_static_masked_and_rows(rng):
    jf, tf = _banks(masking=True)
    img = _image(rng, 4, 64, 128, 'float32')
    sig = (1, 0, 3)
    _, params = _trajectory(rng, jf, 3, 4)
    mask = rng.randn(3, 4, 6).astype(np.float32)
    want = np.asarray(pallas_apply_filter_chain_static(
        jnp.asarray(img), sig, jnp.asarray(params), jf,
        mask_params=jnp.asarray(mask), tile=(32, 128), interpret=True))
    out = torch.zeros(img.shape)
    apply_filter_chain_static(_t(img), sig, _t(params), tf,
                              mask_params=_t(mask), out=out,
                              rows=torch.tensor([2, 1, 0], dtype=torch.int32),
                              n_active=2)
    _assert_match(out[[1, 2]], want[[1, 2]], atol=5e-5)
    assert not out[[0, 3]].any()


# -- the grouped runner --------------------------------------------------

def test_bucket_size():
    assert [bucket_size(n) for n in (1, 8, 9, 12, 13, 17, 25, 33, 49)] == \
        [8, 8, 12, 12, 16, 24, 32, 48, 64]


def test_runner_fused_route(rng):
    jf, tf = _banks()
    b = 6
    img8 = _image(rng, b, 64, 128, 'uint8')
    ids, params = _trajectory(rng, jf, 4, b)
    runner = GroupedChainRunner(tf)
    got = runner(_t(img8), _t(ids), _t(params))
    n_sigs = len({tuple(c) for c in ids.T})
    assert runner.last_route['route'] == 'fused'
    assert len(runner.last_route['groups']) == n_sigs > 1
    assert runner.launches == {'static_chain': n_sigs}
    _assert_match(got, _switch_jax(img8, ids, params, jf))


def test_runner_single_active_and_fallback(rng):
    jf, tf = _banks()
    b = 4
    img = _image(rng, b, 64, 64, 'float32')
    ids, params = _trajectory(rng, jf, 3, b)
    active = np.asarray([[1] * b, [1] * b, [0] * b], np.float32)
    want = _switch_jax(img, ids, params, jf, active_steps=_j(active))
    runner = GroupedChainRunner(tf)
    _assert_match(runner(_t(img), _t(ids), _t(params),
                         active_steps=_t(active)), want)
    runner0 = GroupedChainRunner(tf, max_signatures=0)
    got0 = runner0(_t(img), _t(ids), _t(params), active_steps=_t(active))
    assert runner0.last_route['route'] == 'fallback'
    assert runner0.launches == {'switch_chain': 1}
    _assert_match(got0, want)
    # one signature across the batch: one K3 call on the batch as it is
    ids1 = np.tile(ids[:, :1], (1, b))
    got1 = runner(_t(img), _t(ids1), _t(params))
    assert runner.last_route == {'route': 'single',
                                 'signature': tuple(ids[:, 0].tolist())}
    _assert_match(got1, _switch_jax(img, ids1, params, jf))


def test_runner_masked(rng):
    jf, tf = _banks(masking=True)
    b = 3
    img = _image(rng, b, 64, 128, 'float32')
    ids, params = _trajectory(rng, jf, 3, b)
    mask = rng.randn(3, b, 6).astype(np.float32)
    runner = GroupedChainRunner(tf)
    got = runner(_t(img), _t(ids), _t(params), mask_params=_t(mask))
    assert runner.last_route['route'] == 'fused'
    _assert_match(got, _switch_jax(img, ids, params, jf,
                                   mask_params=_j(mask)), atol=5e-5)


def test_runner_accumulate_with_merge(rng):
    """fused_set_limit=0: big groups get a K3 call each, the small ones
    merge into one K2 call; a lone small group keeps its K3 call."""
    jf, tf = _banks()
    runner = GroupedChainRunner(tf, fused_set_limit=0, merge_below=4)
    for seed in (3, 4):
        r2 = np.random.RandomState(seed)
        b = 10
        img = _image(r2, b, 64, 128, 'float32')
        ids, params = _trajectory(r2, jf, 4, b)
        ids[:, :b - 3] = ids[:, :1]        # one big group + 3 stragglers
        params[:, :b - 3] = params[:, :1]
        got = runner(_t(img), _t(ids), _t(params))
        route = runner.last_route
        assert route['route'] == 'accumulate'
        assert route['groups'] == [(tuple(ids[:, 0].tolist()), 8)]
        assert route['merge'] == 8 and route['merged_rows'] == 3
        _assert_match(got, _switch_jax(img, ids, params, jf))
    assert runner.launches == {'static_chain': 2, 'switch_chain': 2}
    # a lone small group: its own K3 call, no merge
    r3 = np.random.RandomState(5)
    img = _image(r3, 6, 32, 64, 'uint8')
    ids, params = _trajectory(r3, jf, 3, 6)
    ids[:, :5] = ids[:, :1]
    ids[:, 5] = (ids[:, 0] + 1) % len(jf)
    got = runner(_t(img), _t(ids), _t(params))
    assert runner.last_route['merge'] is None
    assert len(runner.last_route['groups']) == 2
    _assert_match(got, _switch_jax(img, ids, params, jf))


def test_runner_fused_set_limit_switchover(rng):
    """The first fused_set_limit signature sets take the fused route; a
    new set after that takes the accumulate route, a known one stays
    fused."""
    jf, tf = _banks()
    runner = GroupedChainRunner(tf, fused_set_limit=1, merge_below=2)
    b = 6
    r2 = np.random.RandomState(7)
    img = _image(r2, b, 64, 128, 'float32')
    ids1, params1 = _trajectory(r2, jf, 3, b)
    ids2, params2 = _trajectory(np.random.RandomState(8), jf, 3, b)
    out1 = runner(_t(img), _t(ids1), _t(params1))
    assert runner.last_route['route'] == 'fused'
    out2 = runner(_t(img), _t(ids2), _t(params2))
    assert runner.last_route['route'] == 'accumulate'
    runner(_t(img), _t(ids1), _t(params1))
    assert runner.last_route['route'] == 'fused'
    _assert_match(out1, _switch_jax(img, ids1, params1, jf))
    _assert_match(out2, _switch_jax(img, ids2, params2, jf))


def test_runner_program_plan(rng):
    _, tf = _banks()
    runner = GroupedChainRunner(tf, merge_below=4)
    ids = np.zeros((3, 12), np.int32)
    ids[:, 6:9] = 1
    ids[:, 9:11] = 2
    ids[:, 11] = 3
    plan = runner.program_plan(ids)
    assert plan == {'kind': 'groups', 'big': [((0, 0, 0), 8)], 'merge': 8}
    assert runner.program_plan(np.zeros((3, 5), np.int32)) == {
        'kind': 'single', 'sig': (0, 0, 0), 'single_size': 5}
    assert GroupedChainRunner(tf, max_signatures=1).program_plan(ids) == \
        {'kind': 'fallback'}


def test_superset_routing(rng):
    """call_superset over its routing cases: an in-layout group, bucket
    overflow, a signature missing from the layout (the last two merge
    through one K2 call), an empty slot (no call), and a single-signature
    batch (one whole-batch K3 call)."""
    jf, tf = _banks()
    k, nf = 3, len(jf)
    sig_a, sig_b = (0, 1, 2), (2, 0, nf)     # trailing identity step
    sig_c, sig_d = (1, 1, 0), (3, 0, 1)      # missing / absent
    cols = [sig_a] * 6 + [sig_b] * 10 + [sig_c] * 2
    cols = [cols[i] for i in rng.permutation(len(cols))]
    ids = np.asarray(cols, np.int32).T
    b = ids.shape[1]
    img = _image(rng, b, 64, 128, 'float32')
    params = rng.randn(k, b, max_filter_parameters(jf)).astype(np.float32)
    want = _switch_jax(img, ids, params, jf)
    runner = GroupedChainRunner(tf)
    layout = ((sig_a, 8), (sig_b, 8), (sig_d, 8))
    got = runner.call_superset(_t(img), ids, _t(params), layout)
    assert runner.last_route == {'route': 'superset', 'slots': 3,
                                 'filled_slots': 2, 'merge': 8,
                                 'merged_rows': 4}
    assert runner.launches == {'static_chain': 2, 'switch_chain': 1}
    _assert_match(got, want, atol=1e-5)
    again = runner.call_superset(_t(img), ids, _t(params), layout,
                                 ids_device=_t(ids))
    assert torch.equal(got, again)
    ids_one = np.tile(np.asarray(sig_a, np.int32)[:, None], (1, b))
    got1 = runner.call_superset(_t(img), ids_one, _t(params), layout)
    assert runner.last_route['route'] == 'single'
    _assert_match(got1, _switch_jax(img, ids_one, params, jf), atol=1e-5)


def test_warmup_superset(rng):
    """warmup_superset runs the layout and each merge size once (no
    launch: padded rows only) and reports them; a live batch inside the
    layout then replays through it."""
    jf, tf = _banks()
    k = 3
    sig_a, sig_b = (0, 1, 2), (2, 0, 1)
    runner = GroupedChainRunner(tf)
    layout = ((sig_a, 8), (sig_b, 8))
    n = runner.warmup_superset(layout, (12, 64, 128, 3), torch.float32, k,
                               max_filter_parameters(jf), merge_sizes=(8,),
                               device='cpu')
    assert n == 2   # the layout + one merge
    assert runner.warmup([(sig_a, 8)], (12, 64, 128, 3), torch.float32, k,
                         max_filter_parameters(jf), device='cpu') == 1
    cols = [sig_a] * 7 + [sig_b] * 3 + [(1, 1, 0)] * 2
    ids = np.asarray(cols, np.int32).T
    img = _image(rng, 12, 64, 128, 'float32')
    params = rng.randn(k, 12, max_filter_parameters(jf)).astype(np.float32)
    got = runner.call_superset(_t(img), ids, _t(params), layout)
    assert runner.last_route['merged_rows'] == 2
    _assert_match(got, _switch_jax(img, ids, params, jf), atol=1e-5)
