"""RGB <-> HSV on the trailing channel axis (torch counterpart of
``exposure_tpu/ops/color_space.py``); every branch is a ``torch.where``."""

import torch


def rgb_to_hsv(img):
    """[..., 3] RGB in [0, 1] -> HSV with h, s, v in [0, 1]."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    rng = v - mn
    one = torch.ones_like(v)
    safe_rng = torch.where(rng > 0, rng, one)
    safe_v = torch.where(v > 0, v, one)
    s = torch.where(v > 0, rng / safe_v, torch.zeros_like(v))
    # jnp.mod is a floored modulo, as is torch.remainder
    hr = torch.remainder((g - b) / safe_rng, 6.0)
    hg = (b - r) / safe_rng + 2.0
    hb = (r - g) / safe_rng + 4.0
    h = torch.where(v == r, hr, torch.where(v == g, hg, hb))
    h = torch.where(rng > 0, h / 6.0, torch.zeros_like(h))
    return torch.stack([h, s, v], dim=-1)


def _select(sextant, cases):
    out = cases[-1]
    for k in range(len(cases) - 2, -1, -1):
        out = torch.where(sextant == k, cases[k], out)
    return out


def hsv_to_rgb(hsv):
    """Inverse of :func:`rgb_to_hsv`."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    dh = h * 6.0
    i = torch.floor(dh)
    f = dh - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sextant = torch.remainder(i.to(torch.int32), 6)
    # jnp.select falls back to 0 where no sextant matches; the sextant
    # is always in [0, 6), so the last case doubles as the default
    r = _select(sextant, [v, q, p, p, t, v])
    g = _select(sextant, [t, v, v, q, p, p])
    b = _select(sextant, [p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)
