"""MIT-Adobe FiveK RAW input provider (a copy of
``exposure_tpu/data/fivek.py``).

Loads the 80x80 augmented pack
``data/fivek_dataset/sup_batched80aug_daylight/image_raw.npy`` (20,000
crops = 5,000 RAW images x 4 random square crops, linearized ProPhotoRGB,
built by :func:`preprocess_raw_aug`) and keeps the crops of the named fold,
selected by image id.  The port never takes ``cv2``: a crop is brought to
80x80 by the JAX code's no-``cv2`` branch, a strided subsample."""

import os
import pickle
import random

import numpy as np

from exposure_tpu_torch.data.folds import read_set
from exposure_tpu_torch.data.provider import DataProvider
from exposure_tpu_torch.utils.image_io import (
    linearize_prophoto_rgb,
    read_tiff16,
)

IMAGE_SIZE = 80
AUGMENTATION_FACTOR = 4
SOURCE_DIR = 'data/fivek_dataset/FiveK_Lightroom_Export_InputDayLight'
BATCHED_DIR = 'data/fivek_dataset/sup_batched%daug_daylight' % IMAGE_SIZE


def preprocess_raw_aug(source_dir=SOURCE_DIR, batched_dir=BATCHED_DIR,
                       limit=None):
    """Build the 80x80 float32 RAW pack from Lightroom TIFF exports: four
    square crops an image at offsets from the global ``random`` module,
    each subsampled to 80x80."""
    os.makedirs(batched_dir, exist_ok=True)
    files = sorted(os.listdir(source_dir))
    if limit:
        files = files[:limit]
    images = np.empty((AUGMENTATION_FACTOR * len(files), IMAGE_SIZE,
                       IMAGE_SIZE, 3), dtype=np.float32)
    meta = {'filenames': list(files)}
    for i, fn in enumerate(files):
        image = read_tiff16(os.path.join(source_dir, fn))
        image = linearize_prophoto_rgb(image)
        shorter = min(image.shape[0], image.shape[1])
        for j in range(AUGMENTATION_FACTOR):
            sx = random.randrange(0, image.shape[0] - shorter + 1)
            sy = random.randrange(0, image.shape[1] - shorter + 1)
            crop = image[sx:sx + shorter, sy:sy + shorter]
            step = max(shorter // IMAGE_SIZE, 1)
            crop = crop[::step, ::step][:IMAGE_SIZE, :IMAGE_SIZE]
            images[i * AUGMENTATION_FACTOR + j] = crop
    with open(os.path.join(batched_dir, 'meta_raw.pkl'), 'wb') as f:
        pickle.dump(meta, f, protocol=-1)
    np.save(os.path.join(batched_dir, 'image_raw.npy'), images)
    return images


class FiveKDataProvider(DataProvider):
    """The crops of fold ``set_name``: crop ``i`` belongs to image id
    ``i // 4 + 1``.  The RAW pack is loaded once a process (a class
    attribute); ``raw=False`` reads ``image_retouched.npy`` instead."""

    _raw_image_pack = None

    @classmethod
    def get_raw_image_pack(cls, batched_dir=BATCHED_DIR):
        if cls._raw_image_pack is None:
            path = os.path.join(batched_dir, 'image_raw.npy')
            if not os.path.exists(path):
                raise FileNotFoundError(
                    '%s missing: build it with preprocess_raw_aug from the '
                    'Lightroom TIFF exports' % path)
            cls._raw_image_pack = np.load(path)
        return cls._raw_image_pack

    def __init__(self, set_name, raw=True, data_root='.', *args, **kwargs):
        fn_list = set(read_set(set_name, data_root))
        if raw:
            data = self.get_raw_image_pack(
                os.path.join(data_root, BATCHED_DIR))
        else:
            data = np.load(os.path.join(data_root, BATCHED_DIR,
                                        'image_retouched.npy'))
        keep = [i for i in range(len(data))
                if (i // AUGMENTATION_FACTOR + 1) in fn_list]
        data = data[np.asarray(keep)]
        super().__init__(data, *args, **kwargs)
