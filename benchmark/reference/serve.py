"""The plain reference of a served batch: the proxy resize, the 5-step plan
of the policy with the serving dropout, and the filter chain on the
full-resolution photo, in float32 with TF32 off.

It reads the policy's weights from the artifact file itself
(``artifact.py``), draws the dropout masks from the batch's seed as the
serving path is specified to (``torch.rand`` of ``[B, features]``, the
shared extractor's then the selector's, step by step, from a generator
seeded by ``dropout_seed(seed, index)``), and applies the filters of the
frozen bank (``frozen/filters.py``, the exact branch set).

A plan whose two best logits lie within ``tie`` of each other at a step is
followed down both branches (at most ``max_leaves`` trajectories an image):
rounding decides such an argmax, so either answer is the plan's.  An image
is judged by the trajectory whose render lies closest to the served one."""

import contextlib

import torch
import torch.nn.functional as F

from benchmark.reference import artifact
from benchmark.reference.frozen.filters import build_filters

# the serving path's dropout stream of batch ``index`` under ``seed``
_SEED_STRIDE = 0x9E3779B1
N_CONVS = 4


class Cfg(dict):
    """A configuration's ``config`` object with attribute access, as the
    frozen modules read it."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


def dropout_seed(seed, index):
    return (int(seed) * _SEED_STRIDE + int(index)) % (2 ** 63)


@contextlib.contextmanager
def tf32(enabled):
    """cuDNN's and cuBLAS's TF32 set to ``enabled`` inside the block."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def resize_matrix(n_in, n_out, device):
    """``[n_out, n_in]`` weights of the antialiased linear resize (a
    triangle filter widened by the scale when shrinking, each row
    normalized), as ``jax.image.resize(..., 'linear')`` defines it."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    centers = (torch.arange(n_out, dtype=torch.float64) + 0.5) * scale
    pos = torch.arange(n_in, dtype=torch.float64) + 0.5
    x = (pos[None, :] - centers[:, None]) / support
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    w = w / w.sum(dim=1, keepdim=True)
    return w.to(torch.float32).to(device)


def proxy(image_u8, size):
    """One ``[H, W, 3]`` uint8 photo -> its ``[size, size, 3]`` float32
    proxy in [0, 1]."""
    x = image_u8.to(torch.float32) * (1.0 / 255.0)
    wy = resize_matrix(x.shape[0], size, x.device)
    wx = resize_matrix(x.shape[1], size, x.device)
    rows = torch.einsum('oh,hwc->owc', wy, x)
    return torch.einsum('pw,owc->opc', wx, rows)


def resize_flops(height, width, size):
    """Multiply-adds of the separable resize of one photo, counted on the
    nonzero taps: rows first (``size x width x 3`` outputs), then columns
    (``size x size x 3``); two operations a tap."""
    wy = resize_matrix(height, size, 'cpu')
    wx = resize_matrix(width, size, 'cpu')
    taps_y = int((wy > 0).sum())        # over all output rows
    taps_x = int((wx > 0).sum())
    return 2 * 3 * (taps_y * width + taps_x * size)


def policy_weights(tree, device):
    """The flax ``PolicyNet`` tree as named tensors on ``device``: convs
    OIHW, dense weights ``[out, in]``."""
    tree = tree.get('params', tree)
    w = {}
    for name, leaf in tree.items():
        if name.endswith('_extractor'):
            for conv, p in leaf.items():
                i = int(conv.split('_')[1])
                w['%s.%d.w' % (name, i)] = torch.from_numpy(
                    p['kernel'].transpose(3, 2, 0, 1).copy())
                w['%s.%d.b' % (name, i)] = torch.from_numpy(p['bias'].copy())
        else:
            w[name + '.w'] = torch.from_numpy(leaf['kernel'].T.copy())
            w[name + '.b'] = torch.from_numpy(leaf['bias'].copy())
    return {k: v.to(torch.float32).to(device) for k, v in w.items()}


def _extractor(w, name, x, keep, keep_prob):
    h = (x - 0.5).permute(0, 3, 1, 2)
    for i in range(N_CONVS):
        h = F.leaky_relu(F.conv2d(h, w['%s.%d.w' % (name, i)],
                                  w['%s.%d.b' % (name, i)], stride=2,
                                  padding=1), 0.2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return h * keep / keep_prob


def _dense(w, name, x):
    return F.linear(x, w[name + '.w'], w[name + '.b'])


def policy(w, x, keeps, keep_prob, n_filters):
    """``(raw heads [n_filters x [n, out_j]], logits [n, n_filters])`` of
    the policy on NHWC inputs ``x``, with the dropout keep masks
    ``keeps = (shared, selector)``."""
    shared = _extractor(w, 'shared_extractor', x, keeps[0], keep_prob)
    raws = [_dense(w, 'filter_%d_fc2' % j, F.leaky_relu(
        _dense(w, 'filter_%d_fc1' % j, shared), 0.2))
        for j in range(n_filters)]
    sel = _extractor(w, 'selector_extractor', x, keeps[1], keep_prob)
    logits = _dense(w, 'selector_fc2', F.leaky_relu(
        _dense(w, 'selector_fc1', sel), 0.2))
    return raws, logits


class ServeReference:
    """The reference of one configuration's served batches, on
    ``device``."""

    def __init__(self, config, artifact_path, device, tie=1e-3,
                 max_leaves=8):
        self.cfg = Cfg(config)
        self.filters = build_filters(self.cfg)
        self.device = torch.device(device)
        self.weights = policy_weights(
            artifact.load(artifact_path)['gen_params'], self.device)
        self.tie, self.max_leaves = float(tie), int(max_leaves)
        self.features = int(self.cfg.feature_extractor_dims)

    # -- the plan --------------------------------------------------------
    def keep_masks(self, seed, index, batch):
        """``[K] x (shared, selector)`` keep masks ``[batch, features]`` of
        batch ``index``: the draws of the whole batch, in order."""
        g = torch.Generator(device=self.device)
        g.manual_seed(dropout_seed(seed, index))
        p = float(self.cfg.dropout_keep_prob)
        out = []
        for _ in range(int(self.cfg.test_steps)):
            out.append(tuple(
                torch.rand((batch, self.features), generator=g,
                           device=self.device) < p for _ in range(2)))
        return out

    def _enrich(self, img, st):
        if not self.cfg.img_include_states:
            return img
        b = st[:, None, None, :].expand(-1, img.shape[1], img.shape[2], -1)
        return torch.cat([img, b], dim=3)

    def _advance(self, st, ids):
        one_hot = F.one_hot(ids.long(), len(self.filters)).to(st.dtype)
        step = st[:, 2:3]
        last = (torch.abs(step + 1 - self.cfg.test_steps) < 1e-4).to(st.dtype)
        return torch.cat([last, last, step + 1,
                          torch.maximum(st[:, 3:], one_hot)], dim=1)

    def _heads(self, img, st, keeps):
        raws, logits = policy(self.weights, self._enrich(img, st), keeps,
                              float(self.cfg.dropout_keep_prob),
                              len(self.filters))
        params = [f.filter_param_regressor(r[:, :f.get_num_filter_parameters()])
                  for f, r in zip(self.filters, raws)]
        return params, logits

    def _apply(self, img, fid, param):
        return self.filters[fid].process(img, param)

    def plan_ids(self, proxies, keeps):
        """``[K, n]`` greedy ids of ``n`` proxies (rows of the masks), in
        one batch: what the chain's operation count is taken on."""
        with torch.no_grad(), tf32(False):
            img = proxies
            st = torch.zeros((img.shape[0], self.cfg.num_state_dim),
                             device=self.device)
            ids_all = []
            for k in range(int(self.cfg.test_steps)):
                params, logits = self._heads(img, st, keeps[k])
                ids = torch.argmax(logits, dim=1)
                nxt = torch.empty_like(img)
                for fid in range(len(self.filters)):
                    rows = torch.nonzero(ids == fid).squeeze(1)
                    if rows.numel():
                        nxt[rows] = self._apply(img[rows], fid,
                                                params[fid][rows])
                img, st = nxt, self._advance(st, ids)
                ids_all.append(ids)
            return torch.stack(ids_all)

    def trajectories(self, proxy_img, keeps):
        """The plans of one ``[S, S, 3]`` proxy: ``[(ids, params, gap)]``,
        one a trajectory, ``gap`` the widest logit gap below the best that
        the trajectory took at a near-tie (0 when it never left the
        argmax)."""
        leaves = []

        def walk(img, st, k, ids, params, gap):
            if k == int(self.cfg.test_steps):
                leaves.append((ids, params, gap))
                return
            heads, logits = self._heads(img, st, keeps[k])
            logits = logits[0]
            best = float(torch.max(logits))
            order = torch.argsort(logits, descending=True).tolist()
            for rank, fid in enumerate(order):
                g = best - float(logits[fid])
                if rank and (g > self.tie or
                             len(leaves) >= self.max_leaves):
                    break
                p = heads[fid]
                nxt = self._apply(img, fid, p)
                st2 = self._advance(st, torch.tensor([fid],
                                                     device=self.device))
                walk(nxt, st2, k + 1, ids + [fid], params + [p[0]],
                     max(gap, g))

        with torch.no_grad(), tf32(False):
            st = torch.zeros((1, self.cfg.num_state_dim), device=self.device)
            walk(proxy_img[None], st, 0, [], [], 0.0)
        return leaves

    # -- the full-resolution replay --------------------------------------
    def render(self, image_u8, ids, params):
        """The plan on the full-resolution ``[H, W, 3]`` uint8 photo:
        dequantized (x / 255), filtered, quantized (round half to even of
        clip(x, 0, 1) * 255)."""
        with torch.no_grad(), tf32(False):
            x = (image_u8.to(torch.float32) * (1.0 / 255.0))[None]
            for fid, p in zip(ids, params):
                x = self._apply(x, fid, p[None])
            return torch.round(torch.clamp(x[0], 0.0, 1.0) * 255.0).to(
                torch.uint8)

    def judge(self, image_u8, served_u8, keeps_row):
        """Compare the served ``[H, W, 3]`` uint8 answer with the
        reference's: ``{'hist', 'values', 'gap', 'leaves'}`` of the closest
        trajectory: ``hist[d]`` counts the values that differ by ``d`` in
        units of the last bit; ``gap`` the widest logit gap below the best
        that the trajectory took."""
        with torch.no_grad(), tf32(False):
            px = proxy(image_u8, int(self.cfg.source_img_size))
        leaves = self.trajectories(px, keeps_row)
        best = None
        for ids, params, gap in leaves:
            ref = self.render(image_u8, ids, params)
            diff = (ref.to(torch.int16) - served_u8.to(torch.int16)).abs()
            hist = torch.bincount(diff.flatten(), minlength=256).cpu()
            score = (int(hist[2:].sum()), int(diff.max()), gap)
            if best is None or score < best[0]:
                best = (score, hist, gap, ids)
        _, hist, gap, ids = best
        return {'hist': hist, 'values': served_u8.numel(), 'gap': gap,
                'leaves': len(leaves), 'ids': ids}


def over_share(hist, lsb=1):
    """The share of the values in ``hist`` that differ by more than
    ``lsb``."""
    return float(hist[lsb + 1:].sum()) / float(hist.sum())


def tail_lsb(hist, share=1e-4):
    """The smallest difference that all but ``share`` of the values in
    ``hist`` stay at or under (the 99.99th percentile for 1e-4)."""
    cum = torch.cumsum(hist.double(), 0) / float(hist.sum())
    return int(torch.nonzero(cum >= 1.0 - share)[0])


def row_masks(masks, row):
    """The keep masks of one row of a batch's ``keep_masks``."""
    return [tuple(m[row:row + 1] for m in step) for step in masks]


def chain_ids_for(ref, images, seed, index):
    """The reference plan's ``[K, B]`` ids of one whole served batch
    ``images`` (``[B, H, W, 3]`` uint8), for the chain's counts."""
    size = int(ref.cfg.source_img_size)
    with torch.no_grad(), tf32(False):
        proxies = torch.stack([proxy(images[i], size)
                               for i in range(images.shape[0])])
    return ref.plan_ids(proxies, ref.keep_masks(seed, index,
                                                images.shape[0]))


def serve_flops(ref, batch, height, width):
    """FLOPs of one served batch counted on the reference: the policy at
    every step (``torch.utils.flop_counter`` over the reference's own
    forward: convolutions and dense layers), the resize's taps; the
    chain's operations are added by the caller from the ids."""
    from benchmark.counts.flops import Flops
    size = int(ref.cfg.source_img_size)
    channels = 3 + (int(ref.cfg.num_state_dim)
                    if ref.cfg.img_include_states else 0)
    x = torch.zeros((batch, size, size, channels), device='meta')
    keeps = (torch.ones((batch, ref.features), device='meta'),) * 2
    w = {k: torch.empty_like(v, device='meta')
         for k, v in ref.weights.items()}
    with Flops() as counter:
        policy(w, x, keeps, 0.5, len(ref.filters))
    per_step = counter.total
    return {'policy': per_step * int(ref.cfg.test_steps),
            'resize': batch * resize_flops(height, width, size)}

