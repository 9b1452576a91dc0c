"""Inputs and weights made on the device from the run's seed, in a few
large calls, and handed alike to the program and to the reference.

Photos are procedural RAW-style scenes: a coarse colour layout and a finer
luminance texture, bilinearly upsampled, under a per-image exposure (dark,
as linear RAW is) and colour cast.  Every seed draws from the same
distribution, so two seeds ask the same work of the program."""

import math


def generator(seed, device, stream=0):
    """A ``torch.Generator`` on ``device`` for stream ``stream`` of
    ``seed``."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x2545F491 + 0x9E37 * (int(stream) + 1))
                  % (2 ** 63))
    return g


def photos(gen, n, height, width, layout, texture, device, dtype='uint8',
           exposure=(-2.5, 0.5), chunk=None):
    """``[n, height, width, 3]`` photos: uint8 (``x * 255`` truncated) or
    float32 in [0, 1].  ``layout`` and ``texture``: the ``(h, w)`` grids
    of the colour layout and of the texture; ``exposure``: the range of
    the exposure's log2."""
    import torch
    import torch.nn.functional as F
    out_dtype = torch.uint8 if dtype == 'uint8' else torch.float32
    out = torch.empty((n, height, width, 3), dtype=out_dtype, device=device)
    draws = torch.rand((n, 6), generator=gen, device=device)
    base = torch.rand((n, 3) + tuple(layout), generator=gen, device=device)
    detail = torch.rand((n, 1) + tuple(texture), generator=gen,
                        device=device)
    # an exposure of 2^[lo, hi), a cast of +-30% per channel
    lo, hi = exposure
    exposure = torch.exp2(draws[:, 0] * (hi - lo) + lo)
    cast = 0.7 + 0.6 * draws[:, 1:4]
    if chunk is None:
        chunk = max(1, int(2 ** 27 // (height * width * 3)))
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        img = F.interpolate(base[s:e], size=(height, width), mode='bilinear',
                            align_corners=False) * 0.75 + \
            F.interpolate(detail[s:e], size=(height, width), mode='bilinear',
                          align_corners=False) * 0.25
        img = img * (cast[s:e] * exposure[s:e, None])[:, :, None, None]
        img = img.clamp_(0.0, 1.0).permute(0, 2, 3, 1)
        if out_dtype == torch.uint8:
            img = img * 255.0
        out[s:e] = img.to(out_dtype)
    return out


def glorot_params(shapes, gen, device):
    """``{name: tensor}`` for ``shapes`` (``{name: shape}``, a module's
    state_dict order): Glorot-uniform weights, as flax and the reference
    start them, and zero biases, drawn in one call on ``device``."""
    import torch
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    flat = torch.rand(sum(sizes.values()), generator=gen, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        piece = flat[at:at + sizes[k]].view(shape)
        at += sizes[k]
        if k.endswith('.bias'):
            out[k] = torch.zeros(shape, device=device)
            continue
        receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
        fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        out[k] = (piece * (2 * limit) - limit).contiguous()
    return out
