"""``parallel/dryrun.py::dryrun_multigpu(2)`` on the CPU (two spawned
``gloo`` ranks; the kernels' plain versions), against the JAX
``__graft_entry__.py::dryrun_multichip``'s contract: its summary line's
keys, the two fused entries' metrics stacked one row an iteration (3 and
2) and finite with the state equal across ranks, ``resume_equal`` and ``pad_ok`` true,
``dyn_max_lsb``, ``grouped_max_lsb`` and ``superset_max_lsb`` at most 2
against the plain chain, the gathered dynamic output within 1 LSB of one
process's pipeline, and no kernel launched (the CPU runs the plain
versions)."""

import re

import pytest

from torch_train_helpers import few_threads  # noqa: F401 (a fixture)
from exposure_tpu_torch.parallel import dryrun

pytestmark = pytest.mark.usefixtures('few_threads')

JAX_KEYS = ('g_loss', 'emd', 'streaming_g_loss', 'fused_g_loss[-1]',
            'served', 'grouped_max_lsb', 'resume_equal', 'pad_ok',
            'superset_ok', 'superset_max_lsb', 'map_batches_ok', 'dyn_ok',
            'dyn_max_lsb')


@pytest.fixture(scope='module')
def ran(tmp_path_factory):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = dryrun.dryrun_multigpu(
            2, device='cpu', threads=2, serve_batch=16, deadline_s=150,
            work_dir=str(tmp_path_factory.mktemp('dryrun')))
    return out, buf.getvalue()


def test_summary_line_has_the_jax_keys(ran):
    out, printed = ran
    line, = [ln for ln in printed.splitlines()
             if ln.startswith('dryrun_multigpu(2): ok')]
    keys = re.findall(r' ([a-z_\[\]\-1]+)=', line)
    assert tuple(keys) == JAX_KEYS
    assert out['served'] == (16, 96, 128, 3)
    assert 'fused_g_loss[-1]=%.4f ' % out['fused_g_loss'][-1] in line


def test_fused_entries_run_on_cpu_ranks(ran):
    import math
    out, _ = ran
    assert 'fused_not_run' not in out
    assert len(out['fused_g_loss']) == 3
    assert len(out['stream_fused_g_loss']) == 2
    assert all(math.isfinite(v) for v in
               out['fused_g_loss'] + out['stream_fused_g_loss'])


def test_summary_line_names_fused_entries_not_run():
    out = {'world': 2, 'g_loss': 1.0, 'emd': 2.0, 'streaming_g_loss': 3.0,
           'served': (4, 8, 8, 3), 'grouped_max_lsb': 0,
           'resume_equal': True, 'pad_ok': True, 'superset_ok': True,
           'superset_max_lsb': 0, 'map_batches_ok': True, 'dyn_ok': True,
           'dyn_max_lsb': 0, 'fused_not_run': 'a gloo group cannot be '
           'captured'}
    line = dryrun.summary_line(out)
    assert 'fused_g_loss[-1]=not_run ' in line
    assert line.endswith('not run: a gloo group cannot be captured)')


def test_resume_and_pad(ran):
    out, _ = ran
    assert out['resume_equal'] is True and out['pad_ok'] is True


def test_sharded_serving_within_the_jax_bounds(ran):
    out, _ = ran
    for key in ('dyn_max_lsb', 'grouped_max_lsb', 'superset_max_lsb'):
        assert out[key] <= 2, (key, out[key])
    assert out['pipeline_max_lsb'] <= 1
    assert out['dyn_ok'] and out['superset_ok'] and out['map_batches_ok']
    route = out['superset_route']
    assert route['route'] == 'superset' and route['merge'] is not None
    assert out['launches'] == {'dyn_chain': 0, 'static_chain': 0,
                               'switch_chain': 0}
