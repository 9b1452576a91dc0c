"""The plain reference against ``exposure_tpu_torch`` at small sizes on the
CPU: the artifact reader, the resize, the policy with the serving dropout,
the plan and the replay, and the frozen training modules."""

import numpy as np
import pytest
import torch

from benchmark.lib.common import ROOT
from benchmark.reference import artifact
from benchmark.reference import serve as ref_serve
from benchmark.tests.helpers import serve_spec

ARTIFACT = ROOT / 'artifacts/serving/synthetic_explore--best.msgpack.gz'


@pytest.fixture(scope='module')
def pair():
    from exposure_tpu_torch.core.serving import RetouchPipeline
    spec = serve_spec()
    pipe = RetouchPipeline.from_artifact(
        'synthetic_explore', str(ARTIFACT), device='cpu', dynamic=True,
        use_kernels=True, graphs=False)
    ref = ref_serve.ServeReference(spec['config']['config'], str(ARTIFACT),
                                   'cpu')
    return pipe, ref


def test_artifact_reader_matches_the_programs():
    from exposure_tpu_torch.core.artifacts import load_artifact
    ours, theirs = artifact.load(ARTIFACT), load_artifact(str(ARTIFACT))

    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert a == b
    walk(ours, theirs)
    assert artifact.sha256(ARTIFACT) == serve_spec()['config']['weights'][
        'sha256']


@pytest.mark.parametrize('shape', [(96, 128), (301, 199), (64, 64)])
def test_resize_matches_the_programs(shape):
    from exposure_tpu_torch.core.serving import proxy_resize
    g = torch.Generator().manual_seed(sum(shape))
    img = torch.randint(0, 256, (2,) + shape + (3,), generator=g,
                        dtype=torch.uint8)
    theirs = proxy_resize(img, 64)
    ours = torch.stack([ref_serve.proxy(img[i], 64) for i in range(2)])
    assert torch.allclose(ours, theirs, atol=2e-6, rtol=0)


def test_policy_with_the_serving_dropout(pair):
    pipe, ref = pair
    g = torch.Generator().manual_seed(5)
    x = torch.rand((3, 64, 64, 14), generator=g)
    seed, index = 2 ** 31 + 9, 17
    from exposure_tpu_torch.core.serving import batch_generator
    raws, logits = pipe.policy(x, batch_generator(seed, index, 'cpu'))
    keeps = ref.keep_masks(seed, index, 3)[0]
    ours_raw, ours_logits = ref_serve.policy(ref.weights, x, keeps, 0.5, 8)
    assert torch.allclose(ours_logits, logits, atol=1e-5, rtol=1e-5)
    for a, b in zip(ours_raw, raws):
        assert torch.allclose(a, b, atol=1e-5, rtol=1e-5)


def test_plan_and_replay_match_the_programs(pair):
    pipe, ref = pair
    from benchmark.lib.inputs import generator, photos
    imgs = photos(generator(11, 'cpu'), 4, 96, 128, (6, 8), (48, 64), 'cpu')
    seed, index = 123456789012, 3
    out = pipe(imgs, seed, index, device_out=True)
    from exposure_tpu_torch.core.serving import batch_generator
    ids, params, _ = pipe.plan(pipe.proxy(imgs),
                               batch_generator(seed, index, 'cpu'))
    masks = ref.keep_masks(seed, index, 4)
    for row in range(4):
        leaves = ref.trajectories(ref_serve.proxy(imgs[row], 64),
                                  ref_serve.row_masks(masks, row))
        got = ids[:, row].tolist()
        match = [lf for lf in leaves if lf[0] == got]
        assert match, (got, [lf[0] for lf in leaves])
        for p_ref, p_prog in zip(match[0][1], params[:, row]):
            n = p_ref.numel()
            assert torch.allclose(p_ref, p_prog[:n], atol=1e-5, rtol=1e-4)
        r = ref.judge(imgs[row], out[row], ref_serve.row_masks(masks, row))
        assert ref_serve.over_share(r['hist']) == 0.0


def test_frozen_filters_match_the_programs():
    from exposure_tpu_torch.ops.filters import build_filters
    from exposure_tpu_torch.utils.config import load_config
    from benchmark.reference.frozen.filters import build_filters as frozen
    cfg = load_config('example')
    g = torch.Generator().manual_seed(1)
    img = torch.rand((2, 8, 8, 3), generator=g) * 1.2
    for a, b in zip(frozen(ref_serve.Cfg(serve_spec()['config']['config'])),
                    build_filters(cfg)):
        raw = torch.randn((2, a.get_num_filter_parameters()), generator=g)
        pa, pb = a.filter_param_regressor(raw), b.filter_param_regressor(raw)
        assert torch.equal(pa, pb)
        assert torch.equal(a.process(img, pa), b.process(img, pb))
