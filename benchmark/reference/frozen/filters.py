"""The filter bank (torch counterpart of ``exposure_tpu/ops/filters.py``).

Each filter is pure math: ``filter_param_regressor`` maps raw head outputs
[B, n_raw] to bounded parameters [B, n_params], and ``process`` applies
them to an NHWC image [B, H, W, C].  The layouts are the JAX package's, so
the tests compare like with like.  ``build_filters`` instantiates the
bank a config names (by the JAX class ``__name__``).
"""

import math

import torch

from .color_space import hsv_to_rgb, rgb_to_hsv
from .ops import abs_, clip, lerp, rgb2lum, tanh_range


class Filter:
    """Base class: bounded parameter regression + pixel-wise processing."""

    short_name = None
    num_filter_parameters = None

    def __init__(self, cfg):
        self.cfg = cfg

    def get_short_name(self):
        assert self.short_name
        return self.short_name

    def get_num_filter_parameters(self):
        assert self.num_filter_parameters
        return self.num_filter_parameters

    def get_num_mask_parameters(self):
        return 6

    def filter_param_regressor(self, features):
        """[B, n_raw] head outputs -> [B, n_params] bounded parameters."""
        raise NotImplementedError

    def process(self, img, param):
        """[B, H, W, C] x [B, n_params] -> [B, H, W, C]."""
        raise NotImplementedError

    def no_high_res(self):
        return False

    def use_masking(self):
        return self.cfg.masking

    def get_mask(self, img, mask_parameters):
        """Linear-in-(x, y, lum) sigmoid mask; ones when masking is off."""
        if not self.use_masking():
            return torch.ones((1, 1, 1, 1), dtype=img.dtype,
                              device=img.device)
        filter_input_range = 5.0
        p = tanh_range(-filter_input_range, filter_input_range, initial=0)(
            mask_parameters)
        grid_x, grid_y = _mask_grid(img.shape[1], img.shape[2], img.dtype,
                                    img.device)
        inp = (grid_x * p[:, None, None, 0, None] +
               grid_y * p[:, None, None, 1, None] +
               p[:, None, None, 2, None] * (rgb2lum(img) - 0.5) +
               p[:, None, None, 3, None] * 2)
        inp = inp * (self.cfg.maximum_sharpness * p[:, None, None, 4, None] /
                     filter_input_range)
        mask = torch.sigmoid(inp)
        mask = mask * (p[:, None, None, 5, None] / filter_input_range * 0.5 +
                       0.5) * (1 - self.cfg.minimum_strength) + \
            self.cfg.minimum_strength
        return mask

    def apply(self, img, raw_parameters=None, specified_parameter=None,
              mask_parameters=None, high_res=None):
        """Run the filter; returns ``(low_res_out, high_res_out, params)``.

        Give either ``raw_parameters`` (head outputs, regressed here) or
        ``specified_parameter`` (already regressed, e.g. a replayed
        trajectory step; with masking on, the raw mask parameters must
        come along).  ``high_res`` is processed with the same parameters
        (None in, None out); a filter whose ``no_high_res`` is true
        passes it through."""
        if (raw_parameters is None) == (specified_parameter is None):
            raise ValueError('give exactly one of raw_parameters and '
                             'specified_parameter')
        if raw_parameters is not None:
            filter_parameters = self.filter_param_regressor(raw_parameters)
        else:
            if self.use_masking() and mask_parameters is None:
                raise ValueError('a masked filter replayed with '
                                 'specified_parameter needs mask_parameters')
            filter_parameters = specified_parameter
        if mask_parameters is None:
            mask_parameters = torch.zeros(
                (img.shape[0], self.get_num_mask_parameters()),
                dtype=img.dtype, device=img.device)
        mask = self.get_mask(img, mask_parameters)
        low_res_output = lerp(img, self.process(img, filter_parameters), mask)
        high_res_output = None
        if high_res is not None:
            if self.no_high_res():
                high_res_output = high_res
            else:
                hi_mask = self.get_mask(high_res, mask_parameters)
                high_res_output = lerp(
                    high_res, self.process(high_res, filter_parameters),
                    hi_mask)
        return low_res_output, high_res_output, filter_parameters


def _mask_grid(h, w, dtype, device):
    """Normalized centered (x, y) grids used by spatial masks: x runs
    over rows, y over columns."""
    shorter = min(h, w)
    ii = torch.arange(h, dtype=dtype, device=device)
    jj = torch.arange(w, dtype=dtype, device=device)
    gx = (ii + (shorter - h) / 2.0) / shorter - 0.5
    gy = (jj + (shorter - w) / 2.0) / shorter - 0.5
    grid_x = gx[None, :, None, None].expand(1, h, w, 1)
    grid_y = gy[None, None, :, None].expand(1, h, w, 1)
    return grid_x, grid_y


class ExposureFilter(Filter):
    """img * 2**p, p in tanh_range(+-exposure_range)."""

    short_name = 'E'
    num_filter_parameters = 1

    def filter_param_regressor(self, features):
        return tanh_range(-self.cfg.exposure_range, self.cfg.exposure_range,
                          initial=0)(features)

    def process(self, img, param):
        return img * torch.exp(param[:, None, None, :] * math.log(2))


class GammaFilter(Filter):
    """max(img, 1e-3) ** g, g = exp(tanh_range(+-ln gamma_range))."""

    short_name = 'G'
    num_filter_parameters = 1

    def filter_param_regressor(self, features):
        log_gamma_range = math.log(self.cfg.gamma_range)
        return torch.exp(
            tanh_range(-log_gamma_range, log_gamma_range)(features))

    def process(self, img, param):
        return torch.pow(clip(img, lo=0.001),
                         param[:, None, None, :])


class ImprovedWhiteBalanceFilter(Filter):
    """Per-channel scales, red pinned pre-activation, normalized by
    luminance."""

    short_name = 'W'
    num_filter_parameters = 3

    def filter_param_regressor(self, features):
        log_wb_range = 0.5
        # [[0, 1, 1]] made on the device: a tensor built from host data
        # would copy synchronously and stall the serving loop
        mask = torch.ones_like(features[:1])
        mask[:, 0] = 0.0
        features = features * mask
        scaling = torch.exp(tanh_range(-log_wb_range, log_wb_range)(features))
        lum = (1e-5 + 0.27 * scaling[:, 0] + 0.67 * scaling[:, 1] +
               0.06 * scaling[:, 2])
        return scaling * (1.0 / lum)[:, None]

    def process(self, img, param):
        return img * param[:, None, None, :]


class ColorFilter(Filter):
    """Monotone piecewise-linear curve per RGB channel; params are flat
    [B, 3 * curve_steps]."""

    short_name = 'C'

    def __init__(self, cfg):
        super().__init__(cfg)
        self.curve_steps = cfg.curve_steps
        self.channels = 3
        self.num_filter_parameters = self.channels * cfg.curve_steps

    def filter_param_regressor(self, features):
        return tanh_range(*self.cfg.color_curve_range, initial=1)(features)

    def process(self, img, param):
        steps = self.curve_steps
        curve = param.reshape(-1, self.channels, steps)
        curve_sum = torch.sum(curve, dim=2) + 1e-30
        total = img * 0
        for i in range(steps):
            total = total + clip(img - 1.0 * i / steps, 0.0, 1.0 / steps) * \
                curve[:, None, None, :, i]
        return total * (steps / curve_sum)[:, None, None, :]


class ToneFilter(Filter):
    """Global monotone tone curve shared by all channels."""

    short_name = 'T'

    def __init__(self, cfg):
        super().__init__(cfg)
        self.curve_steps = cfg.curve_steps
        self.num_filter_parameters = cfg.curve_steps

    def filter_param_regressor(self, features):
        return tanh_range(*self.cfg.tone_curve_range)(features)

    def process(self, img, param):
        steps = self.curve_steps
        curve_sum = torch.sum(param, dim=1) + 1e-30
        total = img * 0
        for i in range(steps):
            total = total + clip(img - 1.0 * i / steps, 0.0, 1.0 / steps) * \
                param[:, i, None, None, None]
        return total * (steps / curve_sum)[:, None, None, None]


class VignetFilter(Filter):
    """Elliptical vignette: ``process`` zeroes the image and the mask
    blends it back."""

    short_name = 'V'
    num_filter_parameters = 1

    def filter_param_regressor(self, features):
        return torch.sigmoid(features)

    def process(self, img, param):
        return img * 0

    def get_num_mask_parameters(self):
        return 5

    def get_mask(self, img, mask_parameters):
        filter_input_range = 5.0
        p = tanh_range(-filter_input_range, filter_input_range, initial=0)(
            mask_parameters)
        grid_x, grid_y = _mask_grid(img.shape[1], img.shape[2], img.dtype,
                                    img.device)
        inp = ((grid_x * p[:, None, None, 0, None]) ** 2 +
               (grid_y * p[:, None, None, 1, None]) ** 2 +
               p[:, None, None, 2, None] - filter_input_range)
        inp = inp * (self.cfg.maximum_sharpness * p[:, None, None, 3, None] /
                     filter_input_range)
        mask = torch.sigmoid(inp)
        mask = mask * (p[:, None, None, 4, None] / filter_input_range * 0.5 +
                       0.5)
        if not self.use_masking():
            mask = mask * 0 + 1
        return mask


class ContrastFilter(Filter):
    """Cosine luminance remap blended by a tanh-bounded strength."""

    short_name = 'Ct'
    num_filter_parameters = 1

    def filter_param_regressor(self, features):
        return torch.tanh(features)

    def process(self, img, param):
        luminance = clip(rgb2lum(img), 0.0, 1.0)
        contrast_lum = -torch.cos(math.pi * luminance) * 0.5 + 0.5
        contrast_image = img / (luminance + 1e-6) * contrast_lum
        return lerp(img, contrast_image, param[:, :, None, None])


class WNBFilter(Filter):
    """Blend toward luminance (black & white)."""

    short_name = 'BW'
    num_filter_parameters = 1

    def filter_param_regressor(self, features):
        return torch.sigmoid(features)

    def process(self, img, param):
        luminance = rgb2lum(img)
        return lerp(img, luminance, param[:, :, None, None])


class LevelFilter(Filter):
    """Levels: clip((x - lo) / (hi - lo))."""

    short_name = 'Le'
    num_filter_parameters = 2

    def filter_param_regressor(self, features):
        return torch.sigmoid(features)

    def process(self, img, param):
        lower = param[:, 0][:, None, None, None]
        upper = (param[:, 1] + 1)[:, None, None, None]
        return clip((img - lower) / (upper - lower + 1e-6), 0.0, 1.0)


class SaturationPlusFilter(Filter):
    """Value-aware saturation boost via an HSV round trip."""

    short_name = 'S+'
    num_filter_parameters = 1

    def filter_param_regressor(self, features):
        return torch.sigmoid(features)

    def process(self, img, param):
        img = clip(img, hi=1.0)
        hsv = rgb_to_hsv(img)
        s = hsv[..., 1:2]
        v = hsv[..., 2:3]
        enhanced_s = s + (1 - s) * (0.5 - abs_(0.5 - v)) * 0.8
        hsv1 = torch.cat([hsv[..., 0:1], enhanced_s, hsv[..., 2:]], dim=-1)
        full_color = hsv_to_rgb(hsv1)
        p = param[:, :, None, None]
        return img * (1.0 - p) + full_color * p


FILTER_CLASSES = {cls.__name__: cls for cls in (
    ExposureFilter, GammaFilter, ImprovedWhiteBalanceFilter, ColorFilter,
    ToneFilter, VignetFilter, ContrastFilter, WNBFilter, LevelFilter,
    SaturationPlusFilter)}


def build_filters(cfg):
    """Instantiate the bank ``cfg.filters`` names, in order."""
    return [FILTER_CLASSES[name](cfg) for name in cfg.filters]


def max_filter_parameters(filters):
    """Largest parameter count across the bank: the packed trajectory
    parameter width the replay kernel consumes."""
    return max(f.get_num_filter_parameters() for f in filters)
