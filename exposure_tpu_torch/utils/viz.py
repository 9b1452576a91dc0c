"""Visualization: annotated panels for training grids and eval strips, the
counterpart of ``exposure_tpu/utils/viz.py`` (numpy on the host):

- value/reward/critic-score overlays;
- the per-step "debugger" panels: action-pdf bars and the selected
  operation's details, drawn per filter.

cv2 is optional: without it, panels degrade to bare bars and swatches (no
text, no curve lines).  ``draw_mask_panel`` evaluates the port's
``Filter.get_mask`` on CPU tensors."""

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _cv2_draw(img, draw_fn):
    """Run a cv2 drawing op on a float [0,1] image (OpenCV >= 5 requires
    uint8 canvases for text/shape drawing)."""
    tmp = np.ascontiguousarray(np.clip(img, 0, 1) * 255).astype(np.uint8)
    draw_fn(tmp)
    img[:] = tmp.astype(np.float32) / 255.0
    return img


def _c255(color):
    return tuple(int(np.clip(c, 0, 1) * 255) for c in color)


def _put_text(img, text, org, scale=0.25, color=(0, 0, 0), thickness=1):
    if cv2 is not None:
        _cv2_draw(img, lambda t: cv2.putText(
            t, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, _c255(color),
            thickness))
    return img


def _rect(img, p1, p2, color, filled=True):
    if cv2 is not None:
        _cv2_draw(img, lambda t: cv2.rectangle(
            t, p1, p2, _c255(color), cv2.FILLED if filled else 1))
    else:
        x1, y1 = p1
        x2, y2 = p2
        img[max(y1, 0):y2, max(x1, 0):x2] = color
    return img


def _line(img, p1, p2, color, thickness=1):
    if cv2 is not None:
        _cv2_draw(img, lambda t: cv2.line(t, p1, p2, _c255(color),
                                          thickness))
    return img


def draw_value_reward_score(img, value, reward, score, gan='w'):
    """Overlay V(s), reward and the centered critic score."""
    img = img.copy()
    img[:14] = img[:14] * 0.5 + 0.25
    img[50:] = img[50:] * 0.5 + 0.25
    scale = 1.0 if gan == 'ls' else 10.0
    red = -np.tanh(float(score) / scale) * 0.5 + 0.5
    color = (1.0, 1.0 - red, 1.0 - red)
    _put_text(img, '%+.2f %+.2f' % (value, reward), (3, 7), 0.25, color)
    _put_text(img, '%+.3f' % score, (10, 60), 0.35, color)
    return img


def draw_score(img, score, gan='w'):
    """Critic-score stamp only."""
    img = img.copy()
    img[50:] = img[50:] * 0.5 + 0.25
    scale = 1.0 if gan == 'ls' else 10.0
    red = -np.tanh(float(score) / scale) * 0.5 + 0.5
    _put_text(img, '%+.3f' % score, (10, 60), 0.35,
              (1.0, 1.0 - red, 1.0 - red))
    return img


# ---------------------------------------------------------------------------
# Per-filter operation panels
# ---------------------------------------------------------------------------

def _draw_label(canvas, text):
    _rect(canvas, (8, 40), (56, 52), (1.0, 1.0, 1.0))
    _put_text(canvas, text, (8, 48), 0.3, (0, 0, 0))
    return canvas


def _draw_curve(canvas, knots, color):
    """Cumulative piecewise-linear curve plot."""
    h, w = canvas.shape[:2]
    values = np.concatenate([[0.0], np.asarray(knots, np.float64)])
    values /= values.sum() + 1e-30
    values = np.cumsum(values)
    steps = len(knots)
    for j in range(steps):
        p1 = (int(w / steps * j), int(h - 1 - values[j] * h))
        p2 = (int(w / steps * (j + 1)), int(h - 1 - values[j + 1] * h))
        _line(canvas, p1, p2, color)
    return canvas


def draw_operation_panel(filter_obj, params, canvas=None, size=64):
    """Draw what the selected filter did, given its regressed parameters
    (flat array)."""
    if canvas is None:
        canvas = np.full((size, size, 3), 0.5, np.float32)
    name = filter_obj.get_short_name()
    p = np.asarray(params).reshape(-1)
    if name == 'E':
        _draw_label(canvas, 'EV %+.2f' % p[0])
    elif name == 'G':
        _draw_label(canvas, 'G 1/%.2f' % (1.0 / max(p[0], 1e-6)))
    elif name == 'W':
        s = canvas.shape[0]
        _rect(canvas, (int(s * 0.2), int(s * 0.4)),
              (int(s * 0.8), int(s * 0.6)),
              tuple(float(np.clip(x, 0, 1)) for x in p[:3]))
    elif name == 'T':
        _draw_curve(canvas, p, (0, 0, 0))
    elif name == 'C':
        k = len(p) // 3
        for c, color in enumerate([(1, 0, 0), (0, 1, 0), (0, 0, 1)]):
            _draw_curve(canvas, p[c * k:(c + 1) * k], color)
    elif name == 'Ct':
        _draw_label(canvas, 'Ct %+.2f' % p[0])
    elif name == 'BW':
        _draw_label(canvas, 'B&W%+.2f' % p[0])
    elif name == 'S+':
        _draw_label(canvas, 'S %+.2f' % p[0])
    elif name == 'Le':
        _draw_label(canvas, '%.2f %.2f' % (p[0], p[1] + 1))
    elif name == 'V':
        v = float(np.clip(p[0], 0, 1))
        _rect(canvas, (8, 40), (56, 52), (v, v, v))
    return canvas


def draw_decision_panel(pdf, selected, short_names, size=64):
    """Action-distribution bars with the chosen filter highlighted."""
    img = np.full((size, size, 3), 0.5, np.float32)
    bar = 8
    c = 0
    for i, p in enumerate(np.asarray(pdf).reshape(-1)):
        if p < 1e-10:
            continue
        per_col = 4
        x = c // per_col * 30
        y = bar * (c % per_col + 1)
        c += 1
        _put_text(img, short_names[i], (x + 6, y + 4), 0.233, (1, 1, 1))
        color = 1.0 if i == selected else 0.3
        width = int(float(p) * 20)
        height = 0.35
        tl = (x + 16, int(y + (1 - height) * bar // 2))
        br = (x + 16 + width, int(y + (1 + height) * bar // 2))
        _rect(img, (tl[0] - 1, tl[1] - 1), (br[0] + 1, br[1] + 1),
              (1.0, 1.0, 1.0))
        _rect(img, tl, br, (color, 0.3, 0.3))
    return img


def draw_mask_panel(filter_obj, input_img, mask_params):
    """Grayscale rendering of the spatial mask the selected filter applied
    on this step's input image, with the 0.5-strength contour marked in
    red; for the vignette this draws the ellipse."""
    import torch
    img = np.asarray(input_img, np.float32)[None]
    n = filter_obj.get_num_mask_parameters()
    mp = np.asarray(mask_params, np.float32).reshape(1, -1)[:, :n]
    mask = filter_obj.get_mask(torch.from_numpy(img),
                               torch.from_numpy(mp)).numpy()
    mask = np.broadcast_to(mask[0, :, :, 0], img.shape[1:3])
    canvas = np.repeat(np.clip(mask, 0, 1)[:, :, None], 3,
                       axis=2).astype(np.float32).copy()
    over = mask > 0.5
    edge = ((over != np.roll(over, 1, axis=0)) |
            (over != np.roll(over, 1, axis=1)))
    edge[0, :] = False
    edge[:, 0] = False
    canvas[edge] = (1.0, 0.2, 0.2)
    _put_text(canvas, 'M %s' % filter_obj.get_short_name(), (3, 8), 0.25,
              (1.0, 0.5, 0.2))
    return canvas


def draw_step_panels(filters, debug_step, size=64):
    """(decision, operation) panel pair for one trajectory step; input is
    one entry of the evaluator's debug list."""
    decision = draw_decision_panel(
        debug_step['pdf'], debug_step['filter_id'],
        [f.get_short_name() for f in filters], size)
    operation = draw_operation_panel(
        filters[debug_step['filter_id']], debug_step['filter_parameters'],
        size=size)
    return decision, operation
