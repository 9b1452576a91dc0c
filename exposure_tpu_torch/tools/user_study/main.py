"""User-study UI: ``python -m exposure_tpu_torch.tools.user_study.main
<folder> <user>`` — a 4-step photo editor mirroring the agent's action
space for collecting human baselines (the port's copy of
``exposure_tpu/tools/user_study/main.py``; reference
user_study_ui/main.py:314-322).

Requires PyQt5, imported only inside ``run_qt``; the editing logic itself
lives in ``session.py`` and works headlessly (this module is a thin
shell).  Inputs are read through the port's ``utils/image_io.py``."""

import os
import sys

import numpy as np

from exposure_tpu_torch.tools.user_study.filters import all_filters
from exposure_tpu_torch.tools.user_study.session import (
    NUM_STEPS,
    RetouchSession,
)


def load_inputs(folder):
    """Load study inputs: .npy image dumps or regular image files."""
    from exposure_tpu_torch.utils.image_io import read_image
    images = []
    for fn in sorted(os.listdir(folder)):
        path = os.path.join(folder, fn)
        name = os.path.splitext(fn)[0]
        if fn.endswith('.npy'):
            images.append((name, np.load(path).astype(np.float32)))
        elif fn.lower().endswith(('.jpg', '.jpeg', '.png', '.tif',
                                  '.tiff')):
            images.append((name, read_image(path)))
    return images


def run_qt(folder, user):
    try:
        from PyQt5 import QtCore
    except ImportError as e:
        raise ImportError('the user-study UI needs PyQt5, which is not '
                          'installed; the headless RetouchSession '
                          '(exposure_tpu_torch.tools.user_study) works '
                          'without it') from e
    from PyQt5.QtGui import QImage, QPixmap
    from PyQt5.QtWidgets import (
        QApplication, QComboBox, QGridLayout, QLabel, QPushButton, QSlider,
        QTabWidget, QVBoxLayout, QWidget,
    )

    inputs = load_inputs(folder)
    assert inputs, 'no inputs in %s' % folder

    class Window(QWidget):
        def __init__(self):
            super().__init__()
            self.index = 0
            self.session = None
            self.preview = QLabel()
            self.tabs = QTabWidget()
            self.step_widgets = []
            layout = QVBoxLayout()
            layout.addWidget(self.preview)
            layout.addWidget(self.tabs)
            btn = QPushButton('Save && Next')
            btn.clicked.connect(self.save_and_next)
            layout.addWidget(btn)
            self.setLayout(layout)
            self.load_image()

        def load_image(self):
            name, img = inputs[self.index]
            self.session = RetouchSession(img, user, name)
            self.tabs.clear()
            self.step_widgets = []
            for step in range(NUM_STEPS):
                w = QWidget()
                grid = QGridLayout()
                w.setLayout(grid)
                combo = QComboBox()
                for cls in all_filters:
                    combo.addItem(cls.get_name())
                grid.addWidget(combo, 0, 0, 1, 3)
                sliders = []
                combo.currentIndexChanged.connect(
                    lambda idx, s=step: self.pick_filter(s, idx))
                self.step_widgets.append((combo, grid, sliders))
                self.tabs.addTab(w, 'Step %d' % (step + 1))
                self.pick_filter(step, 0)
            self.refresh()

        def pick_filter(self, step, idx):
            self.session.set_step_filter(step, idx)
            combo, grid, sliders = self.step_widgets[step]
            for s in sliders:
                grid.removeWidget(s)
                s.deleteLater()
            sliders.clear()
            f = self.session.current_filter(step)
            for i in range(f.get_num_parameters()):
                slider = QSlider(QtCore.Qt.Horizontal)
                slider.setValue(f.parameters[i])
                slider.valueChanged.connect(
                    lambda v, s=step, j=i: self.slide(s, j, v))
                grid.addWidget(slider, i + 1, 1)
                sliders.append(slider)
            self.refresh()

        def slide(self, step, i, value):
            f = self.session.current_filter(step)
            f.parameters[i] = value
            self.refresh()

        def refresh(self):
            img = self.session.recalculate()
            arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            h, w, _ = arr.shape
            qimg = QImage(arr.tobytes(), w, h, 3 * w, QImage.Format_RGB888)
            self.preview.setPixmap(QPixmap.fromImage(qimg).scaledToWidth(
                600))

        def save_and_next(self):
            self.session.save('user_study_results')
            self.index += 1
            if self.index >= len(inputs):
                self.close()
            else:
                self.load_image()

    app = QApplication(sys.argv)
    win = Window()
    win.show()
    app.exec_()


def main():
    if len(sys.argv) < 3:
        print('Usage: python -m exposure_tpu_torch.tools.user_study.main '
              '<input folder> <user name>')
        sys.exit(1)
    folder, user = sys.argv[1], sys.argv[2]
    try:
        import PyQt5  # noqa: F401
    except ImportError:
        print('PyQt5 not available; the headless session API '
              '(exposure_tpu_torch.tools.user_study.RetouchSession) still '
              'works.')
        sys.exit(2)
    run_qt(folder, user)


if __name__ == '__main__':
    main()
