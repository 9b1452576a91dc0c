"""The port's copy of the user-study tool (``exposure_tpu_torch/tools/
user_study/``) against the JAX package's, on the CPU: every filter's
output on the same image and sliders, a session's steps, its result and
its saved JSON equal the JAX copy's exactly; the Qt shell runs against a
stubbed PyQt5 as ``tests/test_tools.py::TestQtShell`` runs the JAX one, and
without PyQt5 it names the package."""

import json
import sys
import types
from unittest import mock

import numpy as np
import pytest

from exposure_tpu.tools.user_study import filters as j_filters
from exposure_tpu.tools.user_study.session import RetouchSession as JSession
from exposure_tpu_torch.tools.user_study import filters as t_filters
from exposure_tpu_torch.tools.user_study.session import (
    NUM_STEPS,
    RetouchSession,
)


@pytest.fixture
def image():
    return np.random.RandomState(0).rand(12, 10, 3).astype(np.float32)


def test_the_filter_set_is_the_jax_ones():
    assert [c.get_name() for c in t_filters.all_filters] == \
        [c.get_name() for c in j_filters.all_filters]
    for t, j in zip(t_filters.all_filters, j_filters.all_filters):
        assert t.get_parameter_settings() == j.get_parameter_settings()


@pytest.mark.parametrize('index', range(len(t_filters.all_filters)))
def test_each_filter_equals_the_jax_one(image, index):
    rng = np.random.RandomState(index)
    t = t_filters.all_filters[index]()
    j = j_filters.all_filters[index]()
    assert t.parameters == j.parameters
    for _ in range(3):
        values = [int(v) for v in rng.randint(0, 101, t.get_num_parameters())]
        t.parameters, j.parameters = list(values), list(values)
        for i in range(t.get_num_parameters()):
            assert t.get_transformed_parameter(i) == \
                j.get_transformed_parameter(i)
        got, want = t.apply(image.copy()), j.apply(image.copy())
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _edit(session, rng):
    for step in range(NUM_STEPS):
        idx = int(rng.randint(len(t_filters.all_filters)))
        session.set_step_filter(step, idx)
        n = session.current_filter(step).get_num_parameters()
        session.set_parameters(step, rng.randint(0, 101, n).tolist())


def test_session_steps_result_and_json_equal_the_jax_ones(image, tmp_path):
    t = RetouchSession(image, 'tester', 'img0')
    j = JSession(image, 'tester', 'img0')
    _edit(t, np.random.RandomState(7))
    _edit(j, np.random.RandomState(7))
    for upto in range(NUM_STEPS + 1):
        np.testing.assert_array_equal(t.recalculate(upto),
                                      j.recalculate(upto))
    assert t.action_sequence() == j.action_sequence()
    t_img, t_json = t.save(str(tmp_path / 'port'))
    j_img, j_json = j.save(str(tmp_path / 'jax'))
    with open(t_json) as f, open(j_json) as g:
        assert json.load(f) == json.load(g)
    with open(t_img, 'rb') as f, open(j_img, 'rb') as g:
        assert f.read() == g.read()


def _stub_pyqt5(monkeypatch):
    class _Widget:
        def __init__(self, *a, **k):
            pass

        def __getattr__(self, name):
            return mock.MagicMock()

    qtcore = types.ModuleType('PyQt5.QtCore')
    qtcore.Qt = mock.MagicMock()
    qtgui = types.ModuleType('PyQt5.QtGui')
    qtgui.QImage = mock.MagicMock()
    qtgui.QPixmap = mock.MagicMock()
    qtw = types.ModuleType('PyQt5.QtWidgets')
    qtw.QWidget = _Widget
    for name in ('QApplication', 'QComboBox', 'QGridLayout', 'QLabel',
                 'QPushButton', 'QSlider', 'QTabWidget', 'QVBoxLayout'):
        setattr(qtw, name, mock.MagicMock())
    pyqt5 = types.ModuleType('PyQt5')
    pyqt5.QtCore = qtcore
    pyqt5.QtGui = qtgui
    pyqt5.QtWidgets = qtw
    for modname, mod in (('PyQt5', pyqt5), ('PyQt5.QtCore', qtcore),
                         ('PyQt5.QtGui', qtgui),
                         ('PyQt5.QtWidgets', qtw)):
        monkeypatch.setitem(sys.modules, modname, mod)


def test_run_qt_with_stubbed_pyqt5(tmp_path, monkeypatch):
    _stub_pyqt5(monkeypatch)
    np.save(str(tmp_path / 'study0.npy'),
            np.random.RandomState(1).rand(16, 16, 3).astype(np.float32))
    from exposure_tpu_torch.tools.user_study.main import load_inputs, run_qt
    run_qt(str(tmp_path), 'tester')
    (name, img), = load_inputs(str(tmp_path))
    assert name == 'study0' and img.shape == (16, 16, 3)


def test_without_pyqt5_the_shell_names_it(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, 'PyQt5', None)
    from exposure_tpu_torch.tools.user_study import main as shell
    with pytest.raises(ImportError, match='PyQt5'):
        shell.run_qt(str(tmp_path), 'tester')
    monkeypatch.setattr(sys, 'argv', ['main', str(tmp_path), 'tester'])
    with pytest.raises(SystemExit) as e:
        shell.main()
    assert e.value.code == 2 and 'PyQt5' in capsys.readouterr().out
