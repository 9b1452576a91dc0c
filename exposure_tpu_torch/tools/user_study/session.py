"""Headless retouching session for the user study (the port's copy of
``exposure_tpu/tools/user_study/session.py``).

Model layer of the reference ``Retoucher`` (user_study_ui/main.py:91-311):
a human edits an image in NUM_STEPS=4 steps, each step = one filter with
slider parameters; the chain is re-applied from scratch on every change
(main.py:110-115); saving writes the result JPEG plus the operation
sequence as JSON (main.py:282-294).  The Qt front-end in ``main.py`` is a
thin shell over this class so the logic is testable without a display."""

import json
import os

import numpy as np

from exposure_tpu_torch.tools.user_study.filters import all_filters

NUM_STEPS = 4


class RetouchSession:

    def __init__(self, image, user='anonymous', image_name='image'):
        self.user = user
        self.image_name = image_name
        self.original = np.asarray(image, np.float32)
        # one filter bank instance per step
        self.steps = [[cls() for cls in all_filters]
                      for _ in range(NUM_STEPS)]
        self.active_filter = [0] * NUM_STEPS

    def set_step_filter(self, step, filter_index):
        assert 0 <= step < NUM_STEPS
        assert 0 <= filter_index < len(all_filters)
        self.active_filter[step] = filter_index

    def set_parameters(self, step, values):
        f = self.current_filter(step)
        assert len(values) == f.get_num_parameters()
        f.parameters = [int(v) for v in values]

    def current_filter(self, step):
        return self.steps[step][self.active_filter[step]]

    def recalculate(self, upto=NUM_STEPS):
        """Re-apply the whole chain from the original image."""
        img = self.original.copy()
        for step in range(min(upto, NUM_STEPS)):
            img = self.current_filter(step).apply(img)
        return np.clip(img, 0.0, 1.0)

    def action_sequence(self):
        seq = []
        for step in range(NUM_STEPS):
            f = self.current_filter(step)
            seq.append({
                'step': step,
                'filter': f.get_name(),
                'filter_id': self.active_filter[step],
                'parameters': list(f.parameters),
                'transformed_parameters': [
                    f.get_transformed_parameter(i)
                    for i in range(f.get_num_parameters())],
            })
        return seq

    def save(self, out_dir):
        os.makedirs(out_dir, exist_ok=True)
        from exposure_tpu_torch.utils.image_io import write_image
        result = self.recalculate()
        img_path = os.path.join(
            out_dir, '%s_%s.jpg' % (self.image_name, self.user))
        write_image(img_path, result)
        json_path = os.path.join(
            out_dir, '%s_%s.json' % (self.image_name, self.user))
        with open(json_path, 'w') as f:
            json.dump({'user': self.user, 'image': self.image_name,
                       'actions': self.action_sequence()}, f, indent=2)
        return img_path, json_path
