"""Inference: retouch full-resolution photos with a trained policy (torch
counterpart of ``exposure_tpu/core/evaluator.py``).

The K-step policy trajectory is planned on the 64x64 proxy with ``rollout``
(the bank plan, ``is_train=0``), giving packed ``(filter_id, params)``
records; the full-resolution image is then transformed by chain replay.

Replay.  On the card (``device='cuda'``, the default) a replay is one
launch of the dynamic chain kernel (K1, ``ops/dyn_chain.py``) per
resolution group, with the steps after an image's stop folded to the no-op
id.  The JAX evaluator takes the signature-grouped runner on an accelerator
because its switch kernel ran every branch there; K1 branches per image,
serves any mix of trajectories in one launch at any resolution and needs no
host copy of the ids, so the port has no use for grouping here.  A kernel
that fails to build or launch raises: nothing on the card gives way to a
plain version.  On the CPU (``device='cpu'``) a float32 replay is the
branchless chain (``ops/chain.py``), as in the JAX evaluator.

Branch set.  Replay uses the exact branch set (``fast_math=False``), as the
JAX evaluator does; serving's default is the fast set.

``u8=True`` (``eval_batched``) quantizes the linear input with
``clip(x, 0, 1) * 255 + 0.5`` truncated and replays in uint8.  The JAX
evaluator falls back to float32 on the CPU, where its kernel does not
exist; K1's plain version does, so the port honours ``u8`` on both devices.

Proxy.  ``downsample_to_proxy`` is always the antialiased bilinear resize
of ``core/serving.py::proxy_resize`` (equal to ``jax.image.resize(...,
'linear')``), computed on the host.  The JAX function takes ``cv2.resize``
(no antialiasing) when ``cv2`` is installed, so its proxies depend on the
machine; the port's do not.

State.  As in the JAX evaluator, ``Evaluator.state`` is the run's whole
``TrainState`` (``core/train_state.py``), restored from its checkpoint or
given by the caller; ``critic_logits`` scores a batch with its critic
(``probe_critic_family`` and ``select_policy`` rank policies so).

The plan and the critic run in float32 whatever the process's TF32 flags
(``utils/precision.py``, entered by ``rollout`` and ``critic_logits``), as
``RetouchPipeline``'s plans do, so both pick the same filters.  Dropout
stays on at evaluation, as in the reference, drawn from
``core/serving.py::batch_generator(seed, 0, device)``.

Plan graphs (``graphs``, on by default on the card): the plan is captured
once per proxy batch shape as a CUDA graph and replayed
(``core/serving_graph.py``; the JAX evaluator jits it), bit for bit the
per-call plan, which ``graphs=False`` keeps.  The replays stay per call:
their shapes vary by file.

Outputs per input file: ``.linear.png``, ``.input_tone_mapped.png``,
``.retouched.png``, optional ``.intermediateNN.png``, the ``.steps.png``
strip and ``<fn>_debug.pkl`` with the per-step decisions (python scalars,
strings and numpy arrays only, so either package reads the other's).
``Evaluator.seconds`` accumulates the host-clock seconds spent reading
images, planning, replaying and writing images; each span ends in a copy to
the host, so it includes the device's work.
"""

import collections
import contextlib
import os
import pickle
import time

import numpy as np
import torch

from exposure_tpu_torch.core.artifacts import restore_train_state
from exposure_tpu_torch.core.losses import apply
from exposure_tpu_torch.core.rollout import Trajectory, rollout
from exposure_tpu_torch.core.serving import (
    MAX_GRAPHS,
    batch_generator,
    proxy_resize,
)
from exposure_tpu_torch.core.serving_graph import GraphCache
from exposure_tpu_torch.core.train_state import init_train_state
from exposure_tpu_torch.models.networks import build_models
from exposure_tpu_torch.ops.chain import apply_filter_chain, apply_filter_step
from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic
from exposure_tpu_torch.utils.image_io import (
    get_image_center,
    linearize_prophoto_rgb,
    read_image,
    read_tiff16,
    write_image,
)
from exposure_tpu_torch.utils.ops import STATE_STOPPED_DIM
from exposure_tpu_torch.utils.precision import tf32_off

_REALTIME_VIS_FAILED = [False]


def _show_realtime(img, title):
    """Live visualization window; degrades to a one-time notice on a
    machine without a display or without cv2."""
    if _REALTIME_VIS_FAILED[0]:
        return
    try:
        import cv2
        bgr = (np.clip(img[..., ::-1], 0, 1) * 255).astype(np.uint8)
        cv2.imshow(title, bgr)
        cv2.waitKey(1)
    except Exception as e:
        _REALTIME_VIS_FAILED[0] = True
        print('# realtime_vis unavailable (%s); continuing headless' % e)


def load_linear_image(fn):
    """Read + linearize an input photo."""
    if fn.endswith('.tif') or fn.endswith('.tiff'):
        image = read_tiff16(fn)
        return linearize_prophoto_rgb(image).astype(np.float32)
    image = read_image(fn)
    image = np.power(image, 2.2)          # linearize sRGB
    image /= 2 * image.max() + 1e-9       # mimic RAW exposure
    return image.astype(np.float32)


def downsample_to_proxy(image, size=64):
    """Center crop + antialiased bilinear resize to the policy proxy
    resolution, on the host."""
    center = np.ascontiguousarray(get_image_center(image), np.float32)
    return proxy_resize(torch.from_numpy(center)[None], size)[0].numpy()


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class Evaluator:

    def __init__(self, cfg, model_root='models', ckpt=None, state=None,
                 policy=None, device='cuda', fast_math=False, graphs=None):
        """``self.state`` is a ``TrainState``, as in the JAX evaluator:
        ``state`` when given; otherwise the run ``cfg.name``
        (``<config>/<run>``) restored by
        ``core/artifacts.py::restore_train_state`` onto a state initialised
        from ``cfg.seed``: the checkpoint's whole state, or the artifact's
        generator beside an untrained critic and value net.  The policy
        serves ``state.gen_params``.  ``policy``: a ``PolicyNet`` with its
        weights loaded, served as it is, with no train state (``self.state``
        None) and the critic left on the host.  ``graphs``: plan each proxy
        batch shape as a CUDA graph (the default on the card)."""
        self.cfg = cfg
        self.dir = os.path.join(model_root, cfg.name)
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(
                'Evaluator runs on the card by default and no CUDA device '
                'is available; pass device=\'cpu\' to evaluate on the host')
        self.fast_math = bool(fast_math)
        self.masking = bool(cfg.masking)
        self.filters, built, self.critic, self.value = build_models(cfg)
        if policy is None:
            if state is None:
                template = init_train_state(cfg, built, self.critic,
                                            self.value, cfg.get('seed', 0))
                state, step, src = restore_train_state(
                    cfg.name, template, model_root, ckpt)
                print('# restored %s at step %d (%s)' % (self.dir, step, src))
                if src == 'artifact':
                    print('# %s: the artifact holds the policy alone; the '
                          'critic and the value net are untrained (seed %d)'
                          % (cfg.name, cfg.get('seed', 0)))
            state = state.to(self.device)
            policy = built
            policy.load_state_dict(state.gen_params)
        self.state = state
        self.policy = policy.to(self.device).eval()
        if state is not None:
            self.critic = self.critic.to(self.device).eval()
        self.seconds = collections.defaultdict(float)
        self.graphs = self.device.type == 'cuda' if graphs is None \
            else bool(graphs)
        self._graphs = GraphCache(MAX_GRAPHS)

    @contextlib.contextmanager
    def _timed(self, span):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[span] += time.perf_counter() - t0

    # ------------------------------------------------------------------
    def _replay(self, batch, ids, params, active, mask):
        """The chain on a [B, H, W, 3] tensor of this evaluator's device:
        K1 on the card, the branchless chain (float32) or K1's plain
        version (uint8) on the CPU.  ``active``: [K, B] 0/1 or None."""
        if batch.device.type != self.device.type:
            raise ValueError('batch is on %s, the evaluator on %s'
                             % (batch.device, self.device))
        mask = mask if self.masking else None
        if self.device.type == 'cpu' and batch.dtype == torch.float32:
            return apply_filter_chain(batch, ids, params, self.filters,
                                      active, mask_params=mask)
        return apply_filter_chain_dynamic(
            batch, ids, params, self.filters, active_steps=active,
            mask_params=mask, fast_math=self.fast_math)

    def _step(self, img, fid, params, mask):
        """One recorded step on [B, H, W, 3]: a K=1 launch of K1 on the
        card, the branchless step on the CPU."""
        if self.device.type == 'cpu':
            return apply_filter_step(img, fid, params, self.filters,
                                     mask_params=mask if self.masking
                                     else None)
        return self._replay(img, fid[None], params[None], None, mask[None])

    # ------------------------------------------------------------------
    def _plan(self, proxies, generator):
        return rollout(self.policy, proxies, generator, cfg=self.cfg,
                       filters=self.filters, is_train=0)

    @torch.no_grad()
    def plan_trajectory(self, low_res_batch, generator=None):
        """Run the policy on [B, 64, 64, 3] proxies; returns the
        trajectory (tensors on the evaluator's device) plus the number of
        applied steps per sample (numpy).  ``generator``: the dropout
        stream, by default that of seed 0; it is left where the plan's
        draws leave it."""
        if generator is None:
            generator = batch_generator(0, 0, self.device)
        if not torch.is_tensor(low_res_batch):
            low_res_batch = torch.from_numpy(
                np.asarray(low_res_batch, np.float32))
        if self.graphs:
            graph = self._graphs.get(
                (tuple(low_res_batch.shape), low_res_batch.dtype),
                self._plan, low_res_batch, self.device)
            # the next replay overwrites the graph's outputs
            traj = Trajectory(*(t.clone() for t in graph.run(
                low_res_batch, generator)))
        else:
            traj = self._plan(low_res_batch.to(self.device), generator)
        stopped = _host(traj.states[:, :, STATE_STOPPED_DIM])  # [K, B]
        k, b = stopped.shape
        applied = np.full((b,), k, np.int32)
        for i in range(b):
            nz = np.nonzero(stopped[:, i] > 0)[0]
            if len(nz):
                applied[i] = nz[0] + 1
        return traj, applied

    def active_mask(self, traj):
        """[K, B] 0/1 float32 numpy mask of steps to replay (stop after the
        first terminal state), computed on the host."""
        stopped = _host(traj.states[:, :, STATE_STOPPED_DIM]) > 0
        k, b = stopped.shape
        active = np.ones((k, b), np.float32)
        for i in range(1, k):
            active[i] = active[i - 1] * (~stopped[i - 1])
        return active

    @torch.no_grad()
    @tf32_off()
    def critic_logits(self, images):
        """The critic's logits ([B, 1] numpy) of [B, S, S, 3] float32
        images, on ``self.state.crit_params``, TF32 off."""
        if self.state is None:
            raise ValueError('an Evaluator given policy= has no train state, '
                             'so no critic weights')
        x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        return _host(apply(self.critic, self.state.crit_params, x))

    @torch.no_grad()
    def retouch(self, high_res_batch, traj):
        """Replay the trajectory on [B, H, W, 3] at full resolution;
        returns a numpy array."""
        high = torch.as_tensor(np.asarray(high_res_batch)).to(
            self.device).contiguous()
        active = torch.from_numpy(self.active_mask(traj)).to(self.device)
        return self._replay(high, traj.filter_ids, traj.params, active,
                            traj.mask_params).cpu().numpy()

    @staticmethod
    def _by_resolution(images):
        """Indices of ``images`` grouped by shape, in order of first
        appearance."""
        by_res = {}
        for i, im in enumerate(images):
            by_res.setdefault(im.shape, []).append(i)
        return list(by_res.values())

    @torch.no_grad()
    def replay_images(self, images, traj, u8=False):
        """Replay row i of ``traj`` on ``images[i]`` ([H, W, 3] float32
        linear, any mix of sizes): one chain replay per resolution group.
        Returns the float32 outputs in the order of ``images``; with ``u8``
        each group is quantized first and replayed in uint8."""
        active = torch.from_numpy(self.active_mask(traj)).to(self.device)
        outs = [None] * len(images)
        for idxs in self._by_resolution(images):
            stacked = np.stack([images[i] for i in idxs])
            if u8:
                stacked = (np.clip(stacked, 0, 1) * 255.0 +
                           0.5).astype(np.uint8)
            batch = torch.from_numpy(stacked).to(self.device)
            sel = torch.as_tensor(idxs, device=self.device)
            group = self._replay(
                batch, traj.filter_ids[:, sel], traj.params[:, sel],
                active[:, sel], traj.mask_params[:, sel]).cpu().numpy()
            if u8:
                group = group.astype(np.float32) / 255.0
            for j, i in enumerate(idxs):
                outs[i] = group[j]
        return outs

    # ------------------------------------------------------------------
    def eval_batched(self, spec_files, output_dir='./outputs', seed=0,
                     show_linear=True, show_input=True, u8=False):
        """Batch-process inputs grouped by resolution: one rollout call
        for all proxies and one chain replay per resolution group.

        ``u8=True`` replays in uint8: the linearized input is quantized to
        8 bits first, so deep-shadow precision below 1/255 is traded for
        4x less memory traffic; the result is within 1 u8 LSB of the
        float32 path on its own quantization grid."""
        os.makedirs(output_dir, exist_ok=True)
        with self._timed('read'):
            images = [load_linear_image(fn) for fn in spec_files]
        with self._timed('plan'):
            proxies = np.stack([
                downsample_to_proxy(im, self.cfg.source_img_size)
                for im in images])
            traj, applied = self.plan_trajectory(
                proxies, batch_generator(seed, 0, self.device))
        with self._timed('replay'):
            outs = self.replay_images(images, traj, u8=u8)
        results = []
        for idxs in self._by_resolution(images):
            for i in idxs:
                base = os.path.basename(spec_files[i])
                with self._timed('write'):
                    if show_linear:
                        write_image(os.path.join(
                            output_dir, base + '.linear.png'),
                            np.clip(images[i], 0, 1))
                    if show_input:
                        tone = (images[i] / images[i].max()) ** (1 / 2.4)
                        write_image(os.path.join(
                            output_dir, base + '.input_tone_mapped.png'),
                            np.clip(tone, 0, 1))
                    write_image(os.path.join(
                        output_dir, base + '.retouched.png'),
                        np.clip(outs[i], 0, 1))
                results.append({'file': spec_files[i],
                                'retouched': outs[i],
                                'steps_applied': int(applied[i])})
        return results

    @torch.no_grad()
    def eval(self, spec_files, output_dir='./outputs', step_by_step=False,
             show_linear=True, show_input=True, seed=0):
        os.makedirs(output_dir, exist_ok=True)
        results = []
        for fn in spec_files:
            print('Processing input {}'.format(fn))
            with self._timed('read'):
                high_res = load_linear_image(fn)
            with self._timed('plan'):
                low_res = downsample_to_proxy(high_res,
                                              self.cfg.source_img_size)
                traj, applied = self.plan_trajectory(
                    low_res[None], batch_generator(seed, 0, self.device))
            base = os.path.basename(fn)
            n_applied = int(applied[0])

            def save(tag, img):
                with self._timed('write'):
                    write_image(os.path.join(output_dir,
                                             base + '.' + tag + '.png'),
                                np.clip(img, 0, 1))

            if step_by_step:
                with self._timed('replay'):
                    img = torch.from_numpy(high_res[None]).to(self.device)
                for i in range(n_applied):
                    with self._timed('replay'):
                        img = self._step(img, traj.filter_ids[i],
                                         traj.params[i], traj.mask_params[i])
                        shown = img[0].cpu().numpy()
                    if i < n_applied - 1:
                        save('intermediate%02d' % i, shown)
                    if self.cfg.get('vis_step_test', False):
                        _show_realtime(shown, 'step %d: %s' % (i, base))
                retouched = img[0].cpu().numpy()
            else:
                with self._timed('replay'):
                    retouched = self.retouch(high_res[None], traj)[0]

            if show_linear:
                save('linear', high_res)
            if show_input:
                tone_mapped = (high_res / high_res.max()) ** (1 / 2.4)
                save('input_tone_mapped', tone_mapped)
            save('retouched', retouched)

            # per-step debug dump, on the host
            ids = _host(traj.filter_ids)
            params = _host(traj.params)
            mask_params = _host(traj.mask_params)
            pdfs = _host(traj.pdfs)
            debug = []
            for i in range(ids.shape[0]):
                fid = int(ids[i, 0])
                f = self.filters[fid]
                n = f.get_num_filter_parameters()
                debug.append({
                    'step': i,
                    'filter_id': fid,
                    'short_name': f.get_short_name(),
                    'all_short_names': [x.get_short_name()
                                        for x in self.filters],
                    'filter_parameters': params[i, 0, :n].copy(),
                    'mask_parameters': mask_params[
                        i, 0, :f.get_num_mask_parameters()].copy(),
                    'pdf': pdfs[i, 0].copy(),
                    'applied': i < n_applied,
                })
            with open(os.path.join(output_dir, base + '_debug.pkl'),
                      'wb') as f:
                pickle.dump(debug, f)

            # steps figure: row 0 = input proxy + per-step low-res
            # outputs; row 1 = decision (pdf) panels; row 2 = operation
            # panels; with masking on, row 3 = per-step spatial masks
            from exposure_tpu_torch.utils.viz import (
                draw_mask_panel,
                draw_step_panels,
            )
            step_images = _host(traj.images[:n_applied, 0])
            blank = np.ones_like(low_res)
            row_imgs = [low_res] + list(step_images)
            row_dec, row_op = [blank], [blank]
            row_mask = [blank] if self.masking else None
            for i in range(n_applied):
                dec, op = draw_step_panels(self.filters, debug[i],
                                           size=low_res.shape[0])
                row_dec.append(dec)
                row_op.append(op)
                if row_mask is not None:
                    step_input = low_res if i == 0 else step_images[i - 1]
                    row_mask.append(draw_mask_panel(
                        self.filters[debug[i]['filter_id']], step_input,
                        debug[i]['mask_parameters']))

            def hpad(row):
                return np.hstack([np.pad(r, ((1, 1), (1, 1), (0, 0)),
                                         constant_values=1.0) for r in row])
            strip_rows = [hpad(row_imgs), hpad(row_dec), hpad(row_op)]
            if row_mask is not None:
                strip_rows.append(hpad(row_mask))
            save('steps', np.vstack(strip_rows))
            results.append({'file': fn, 'retouched': retouched,
                            'debug': debug})
        return results
