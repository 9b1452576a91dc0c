"""Target (artist-retouched) set provider (a copy of
``exposure_tpu/data/artist.py``).

Loads ``data/artists/<name>/*`` (expert-retouched renditions), takes the
centre square, subsamples it to ``main_size`` (the JAX code's no-``cv2``
branch: the port never takes ``cv2``) and keeps ``augmentation_factor``
random ``crop_size`` crops with flips an image.  ``set_name='2k_target'``
keeps the files of that fold by their index in the sorted listing."""

import os
import random

import numpy as np

from exposure_tpu_torch.data.folds import read_set
from exposure_tpu_torch.data.provider import DataProvider
from exposure_tpu_torch.utils.image_io import get_image_center, read_image

SOURCE_DIR = 'data/artists'


def _load_crops(folder, files, main_size, crop_size, augmentation_factor):
    """The crops of ``files``, drawing from the global ``random`` module in
    the JAX order: a flip, then the two offsets, for each crop."""
    data = []
    for f in files:
        image = read_image(os.path.join(folder, f))
        image = get_image_center(image)
        step = max(image.shape[0] // main_size, 1)
        image = image[::step, ::step][:main_size, :main_size]
        for _ in range(augmentation_factor):
            new_image = image
            if random.random() < 0.5:
                new_image = new_image[:, ::-1, :]
            sx = random.randrange(main_size - crop_size + 1)
            sy = random.randrange(main_size - crop_size + 1)
            data.append(new_image[sx:sx + crop_size, sy:sy + crop_size])
    return np.stack(data, axis=0)


class ArtistDataProvider(DataProvider):

    def __init__(self,
                 read_limit=-1,
                 name='FiveK_C',
                 main_size=80,
                 crop_size=64,
                 augmentation_factor=4,
                 set_name=None,
                 data_root='.',
                 *args,
                 **kwargs):
        folder = os.path.join(data_root, SOURCE_DIR, name)
        files = sorted(os.listdir(folder))
        if isinstance(set_name, str) and set_name.endswith('.txt'):
            with open(set_name) as f:
                idx = [int(x) for x in f.readlines()]
            files = list(np.array(files)[np.array(idx)])
        elif set_name == '2k_target':
            idx = read_set('2k_target', data_root)
            files = list(np.array(files)[np.array(idx) - 1])
        if read_limit != -1:
            files = files[:read_limit]
        files.sort()
        data = _load_crops(folder, files, main_size, crop_size,
                           augmentation_factor)
        super().__init__(data, *args, **kwargs)
