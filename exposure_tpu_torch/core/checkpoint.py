"""Checkpoint and resume, in the JAX package's file format (torch
counterpart of ``exposure_tpu/core/checkpoint.py``).

A checkpoint is ``<dir>/model.ckpt-<step>.msgpack``: flax msgpack of the
JAX ``TrainState``'s state dict, so either package restores the other's.
Its tree, as ``flax.serialization.to_state_dict`` writes it:

- ``gen_params``, ``val_params``, ``crit_params``: ``{'params': ...}``
  flax trees (``core/artifacts.py::state_dict_to_flax`` and
  ``critic_state_dict_to_flax``; the value net maps as the critic), keys
  sorted;
- ``opt_g``, ``opt_v``, ``opt_c``: optax's chain state, ``{'0':
  {'count', 'mu', 'nu'}, '1': {}}`` (``scale_by_adam``'s state, then
  ``scale``'s ``EmptyState``); the moments map as the parameters;
- ``ema``: ``{'biased', 'count'}``; ``step``.

Every leaf is a numpy array (ext type 1), scalars too, with int32 counts.

Writes go to a temp file, are fsynced and renamed into place, then older
files beyond ``keep`` are pruned; a restore falls back to older files
when the newest is unreadable.  The replay pool is not saved, as in the
reference.
"""

import os
import re

import numpy as np
import torch

from exposure_tpu_torch.core.artifacts import (
    critic_state_dict_to_flax,
    flax_critic_to_state_dict,
    flax_to_state_dict,
    msgpack_restore,
    msgpack_serialize,
    state_dict_to_flax,
)
from exposure_tpu_torch.core.train_state import AdamState, EmaState

_FILE = re.compile(r'model\.ckpt-(\d+)\.msgpack$')
_TREES = (('gen_params', 'opt_g', state_dict_to_flax, flax_to_state_dict),
          ('val_params', 'opt_v', critic_state_dict_to_flax,
           flax_critic_to_state_dict),
          ('crit_params', 'opt_c', critic_state_dict_to_flax,
           flax_critic_to_state_dict))


def _path(directory, step):
    return os.path.join(directory, 'model.ckpt-%d.msgpack' % step)


def _steps(directory):
    return sorted(int(m.group(1)) for m in map(_FILE.match,
                                               os.listdir(directory)) if m)


def state_to_flax(state):
    """The JAX ``TrainState`` state dict of ``state``, numpy leaves."""
    tree = {}
    for params, _, to_flax, _ in _TREES:
        tree[params] = to_flax(getattr(state, params))
    for _, opt, to_flax, _ in _TREES:
        adam = getattr(state, opt)
        tree[opt] = {'0': {'count': np.asarray(adam.count, np.int32),
                           'mu': to_flax(adam.mu), 'nu': to_flax(adam.nu)},
                     '1': {}}
    tree['ema'] = {
        'biased': state.ema.biased.detach().cpu().numpy().astype(np.float32),
        'count': np.asarray(state.ema.count, np.int32)}
    tree['step'] = np.asarray(state.step, np.int32)
    return tree


def _tensors(flax_tree, from_flax, template):
    """A flax tree as a state_dict shaped and placed like ``template``."""
    sd = from_flax(flax_tree)
    if set(sd) != set(template):
        raise ValueError('checkpoint tree mismatch: %s'
                         % sorted(set(sd) ^ set(template)))
    out = {}
    for k, t in template.items():
        if tuple(sd[k].shape) != tuple(t.shape):
            raise ValueError('checkpoint leaf %s is %s, the template %s'
                             % (k, tuple(sd[k].shape), tuple(t.shape)))
        out[k] = sd[k].to(device=t.device, dtype=t.dtype)
    return out


def state_from_flax(tree, template):
    """Inverse of :func:`state_to_flax`, onto ``template``'s keys, shapes
    and devices."""
    try:
        changes = {}
        for params, opt, _, from_flax in _TREES:
            like = getattr(template, params)
            changes[params] = _tensors(tree[params], from_flax, like)
            chain = tree[opt]['0']
            changes[opt] = AdamState(
                count=int(chain['count']),
                mu=_tensors(chain['mu'], from_flax, like),
                nu=_tensors(chain['nu'], from_flax, like))
        biased = template.ema.biased
        changes['ema'] = EmaState(
            biased=torch.tensor(np.asarray(tree['ema']['biased'])).to(
                device=biased.device, dtype=biased.dtype),
            count=int(tree['ema']['count']))
        changes['step'] = int(tree['step'])
    except (KeyError, TypeError) as e:
        raise ValueError('checkpoint tree mismatch: %r' % (e,)) from e
    return template.replace(**changes)


def save_checkpoint(directory, state, step, keep=1):
    """Write ``state`` as ``model.ckpt-<step>.msgpack`` crash-safely, then
    keep only the newest ``keep`` files.  Returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    tmp = path + '.tmp'
    # orphaned temp files of writes a killed process never renamed
    for stale in os.listdir(directory):
        if stale.endswith('.msgpack.tmp') and stale != os.path.basename(tmp):
            try:
                os.remove(os.path.join(directory, stale))
            except OSError:
                pass
    data = msgpack_serialize(state_to_flax(state))
    with open(tmp, 'wb') as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    for old in _steps(directory)[:-keep]:
        os.remove(_path(directory, old))
    return path


def latest_checkpoint_step(directory):
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def _newest_readable(directory, step, convert):
    """``(convert(tree), step)`` of checkpoint ``step``, or of the newest
    file that reads and converts, falling back to older ones."""
    if step is not None:
        candidates = [step]
    else:
        candidates = _steps(directory)[::-1] if os.path.isdir(directory) \
            else []
        if not candidates:
            raise FileNotFoundError('no checkpoint in %s' % directory)
    last_err = None
    for s in candidates:
        path = _path(directory, s)
        try:
            with open(path, 'rb') as f:
                tree = msgpack_restore(f.read())
            return convert(tree), s
        except (ValueError, OSError) as e:
            last_err = e
            print('# checkpoint %s unreadable (%s), trying older' % (path, e))
    raise last_err


def read_checkpoint(directory, step=None):
    """The flax tree of checkpoint ``step`` (default: the newest readable
    one) and its step."""
    return _newest_readable(directory, step, lambda tree: tree)


def restore_checkpoint(directory, template_state, step=None):
    """Restore into the structure and devices of ``template_state``; if the
    newest checkpoint is unreadable (or does not fit the template), fall
    back to older ones.  Returns ``(state, step)``."""
    return _newest_readable(
        directory, step, lambda tree: state_from_flax(tree, template_state))
