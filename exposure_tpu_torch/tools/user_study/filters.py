"""Human-operable filter set for the user study (the port's copy of
``exposure_tpu/tools/user_study/filters.py``, host-only numpy and scipy).

Numpy re-implementations of the agent's action space with slider-friendly
parameterizations, behavioral parity with the reference user-study filters
(reference user_study_ui/filters.py:12-352): each filter declares
parameter settings ``(name, lower, upper, scale[, default])`` where slider
values in [0, 1] map linearly or logarithmically into [lower, upper];
sliders default to 0.5 unless a default is given.

Differences from the training filter bank (intentional, as in the
reference): WB is temperature/tint, tone/color are 3-knot
shadow/midtone/highlight cubic splines, saturation/B&W share one
bidirectional blend.
"""

import math

import numpy as np
from scipy.interpolate import interp1d


def _np_rgb_to_hsv(img):
    try:
        import cv2
        return cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    except ImportError:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        v = np.maximum(np.maximum(r, g), b)
        mn = np.minimum(np.minimum(r, g), b)
        rng = v - mn
        safe = np.where(rng > 0, rng, 1.0)
        h = np.where(v == r, np.mod((g - b) / safe, 6.0),
                     np.where(v == g, (b - r) / safe + 2, (r - g) / safe + 4))
        h = np.where(rng > 0, h * 60.0, 0.0)
        s = np.where(v > 0, rng / np.where(v > 0, v, 1), 0)
        return np.stack([h, s, v], axis=-1).astype(np.float32)


def _np_hsv_to_rgb(hsv):
    try:
        import cv2
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    except ImportError:
        h, s, v = hsv[..., 0] / 60.0, hsv[..., 1], hsv[..., 2]
        i = np.floor(h).astype(int) % 6
        f = h - np.floor(h)
        p = v * (1 - s)
        q = v * (1 - s * f)
        t = v * (1 - s * (1 - f))
        r = np.choose(i, [v, q, p, p, t, v])
        g = np.choose(i, [t, v, v, q, p, p])
        b = np.choose(i, [p, p, t, v, v, q])
        return np.stack([r, g, b], axis=-1).astype(np.float32)


def rgb2lum(image):
    return (0.27 * image[..., 0] + 0.67 * image[..., 1] +
            0.06 * image[..., 2])[..., None]


def lerp(a, b, alpha):
    return (1 - alpha) * a + alpha * b


class Filter:
    """Slider-parameterized filter; parameters stored as ints in [0, 100]."""

    def __init__(self):
        self.parameters = [
            int(s[4] * 100) if len(s) >= 5 else 50
            for s in self.get_parameter_settings()]

    def reset_parameters(self):
        self.__init__()

    @classmethod
    def get_num_parameters(cls):
        return len(cls.get_parameter_settings())

    @classmethod
    def get_parameter_settings(cls):
        return []

    def get_transformed_parameter(self, i):
        _, lower, upper, scale = self.get_parameter_settings(i=i)
        x = self.parameters[i] / 100.0
        if scale == 'linear':
            return x * (upper - lower) + lower
        if scale == 'log':
            return math.exp(x * math.log(1.0 * upper / lower) +
                            math.log(lower))
        raise ValueError(scale)

    @classmethod
    def get_parameter_settings_list(cls):
        return cls.get_parameter_settings()

    def apply(self, img):
        raise NotImplementedError

    @classmethod
    def get_name(cls):
        raise NotImplementedError


# make get_parameter_settings(i=...) convenient
def _settings_dispatch(cls):
    base = cls.get_parameter_settings

    def wrapper(i=None):
        s = base()
        return s if i is None else s[i][:4]
    return wrapper


class ExposureFilter(Filter):
    @classmethod
    def get_parameter_settings(cls, i=None):
        s = [('Exposure', -5, 5, 'linear')]
        return s if i is None else s[i]

    def apply(self, img):
        return img * math.pow(2, self.get_transformed_parameter(0))

    @classmethod
    def get_name(cls):
        return 'Exposure'


class GammaFilter(Filter):
    @classmethod
    def get_parameter_settings(cls, i=None):
        s = [('Gamma', 8.0, 1.0 / 8.0, 'log')]
        return s if i is None else s[i]

    def apply(self, img):
        return np.power(img, self.get_transformed_parameter(0))

    @classmethod
    def get_name(cls):
        return 'Gamma'


class WBFilter(Filter):
    @classmethod
    def get_parameter_settings(cls, i=None):
        limits = 0.5
        s = [('Temperature', -limits, limits, 'linear'),
             ('Tint', -limits, limits, 'linear')]
        return s if i is None else s[i]

    def apply(self, img):
        scaling = np.array(
            (1.0, math.exp(-self.get_transformed_parameter(1)),
             math.exp(-self.get_transformed_parameter(0))), np.float32)
        scaling *= 1.0 / (1e-5 + 0.27 * scaling[0] + 0.67 * scaling[1] +
                          0.06 * scaling[2])
        return img * scaling[None, None, :]

    @classmethod
    def get_name(cls):
        return 'W.B.'


class _SatBase(Filter):
    def _blend(self, img, param):
        hsv = _np_rgb_to_hsv(img)
        s = hsv[..., 1:2]
        v = hsv[..., 2:3]
        enhanced_s = s + (1 - s) * (0.5 - np.abs(0.5 - v))
        hsv_sat = np.concatenate([hsv[..., 0:1], enhanced_s, hsv[..., 2:]],
                                 axis=2)
        hsv_bnw = np.concatenate([hsv[..., 0:1], hsv[..., 1:2] * 0,
                                  hsv[..., 2:]], axis=2)
        bnw = _np_hsv_to_rgb(hsv_bnw)
        full_color = _np_hsv_to_rgb(hsv_sat)
        p = np.float32(param)
        return (max(0.0, -p) * bnw + max(0.0, 1.0 - abs(p)) * img +
                max(0.0, p) * full_color)


class SaturationFilter(_SatBase):
    @classmethod
    def get_parameter_settings(cls, i=None):
        s = [('Saturation', 0, 1, 'linear', 0)]
        return s if i is None else s[i][:4]

    def apply(self, img):
        return self._blend(img, self.get_transformed_parameter(0))

    @classmethod
    def get_name(cls):
        return 'Sat.'


class BNWFilter(_SatBase):
    @classmethod
    def get_parameter_settings(cls, i=None):
        s = [('BNW', 0, -1, 'linear', 0)]
        return s if i is None else s[i][:4]

    def apply(self, img):
        return self._blend(img, self.get_transformed_parameter(0))

    @classmethod
    def get_name(cls):
        return 'B&&W'


class LevelFilter(Filter):
    @classmethod
    def get_parameter_settings(cls, i=None):
        s = [('Black point', 0, 1, 'linear', 0),
             ('White point', 0, 1, 'linear', 1)]
        return s if i is None else s[i][:4]

    def apply(self, img):
        lower = self.get_transformed_parameter(0)
        upper = self.get_transformed_parameter(1)
        upper = lower + upper * (1 - lower)
        return np.clip((img - lower) / (upper - lower + 1e-20), 0, 1)

    @classmethod
    def get_name(cls):
        return 'Level'


class ContrastFilter(Filter):
    @classmethod
    def get_parameter_settings(cls, i=None):
        s = [('Contrast', -1, 1, 'linear', 0.5)]
        return s if i is None else s[i][:4]

    def apply(self, img):
        contrast = np.float32(self.get_transformed_parameter(0))
        contrast_image = -np.cos(math.pi * img) * 0.5 + 0.5
        return lerp(img, contrast_image, contrast)

    @classmethod
    def get_name(cls):
        return 'Contrast'


def get_spline(low, mid, high):
    x = np.array([0, 0.25, 0.5, 0.75, 1], np.float32)
    y = np.array([0, low * 0.25 + 0.25, mid * 0.25 + 0.5,
                  high * 0.25 + 0.75, 1], np.float32)
    return interp1d(x, y, kind='cubic')


class ToneFilter(Filter):
    @classmethod
    def get_parameter_settings(cls, i=None):
        s = [(n, -1, 1, 'linear') for n in ('Shadow', 'Midtone',
                                            'Highlight')]
        return s if i is None else s[i][:4]

    def apply(self, img):
        spline = get_spline(self.get_transformed_parameter(0),
                            self.get_transformed_parameter(1),
                            self.get_transformed_parameter(2))
        return spline(np.clip(img, 0, 1)).astype(np.float32)

    @classmethod
    def get_name(cls):
        return 'Tone'


class ColorFilter(Filter):
    @classmethod
    def get_parameter_settings(cls, i=None):
        names = ['%s %s' % (c, t) for c in ('Red', 'Green', 'Blue')
                 for t in ('Shadow', 'Midtone', 'Highlight')]
        s = [(n, -1, 1, 'linear') for n in names]
        return s if i is None else s[i][:4]

    def apply(self, img):
        img = img.copy()
        for i in range(3):
            spline = get_spline(self.get_transformed_parameter(i * 3),
                                self.get_transformed_parameter(i * 3 + 1),
                                self.get_transformed_parameter(i * 3 + 2))
            img[:, :, i] = spline(np.clip(img[:, :, i], 0, 1))
        return img.astype(np.float32)

    @classmethod
    def get_name(cls):
        return 'Color'


all_filters = [ExposureFilter, GammaFilter, SaturationFilter, WBFilter,
               ContrastFilter, BNWFilter, ToneFilter, ColorFilter]
