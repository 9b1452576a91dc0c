"""Weight importer for the JAX package's serving artifacts.

An artifact (``exposure_tpu/core/artifacts.py``) is a gzip-compressed flax
msgpack map ``{'run', 'step', 'dtype', 'gen_params'}``.  flax writes each
array as msgpack ext type 1 whose payload is itself msgpack
``(shape, dtype_name, C-order bytes)``, and each numpy scalar as ext type
3 with the same payload.  Neither flax nor the ``msgpack`` package is
needed here: ``msgpack_restore`` decodes the subset such files use in
pure Python.  ``flax_to_state_dict`` maps the flax ``gen_params`` tree
onto ``models.networks.PolicyNet``.

``restore_for_serving`` is the by-run lookup the evaluator uses
(``exposure_tpu/core/artifacts.py::restore_for_serving``): the artifact of
``<config>/<run>`` under ``artifacts/serving/``.  The JAX package prefers a
training checkpoint under ``models/<config>/<run>`` when there is one; the
port cannot read those yet (``ROADMAP.md`` item 9c), so a run that has
checkpoints raises instead of quietly serving the artifact's weights in
their place.  The artifact writer waits for 9c too.
"""

import gzip
import os
import re
import struct

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3

ARTIFACT_ROOT = 'artifacts/serving'
_CHECKPOINT_FILE = re.compile(r'model\.ckpt-\d+\.msgpack$')


def artifact_path(run, root=ARTIFACT_ROOT):
    """Where the artifact of ``<config>/<run>`` lives (the '/' is flattened
    so that the artifact directory stays one level deep)."""
    return os.path.join(root, run.replace('/', '--') + '.msgpack.gz')


def has_checkpoint(run, model_root='models'):
    """True when ``<model_root>/<run>`` holds a training checkpoint
    (``model.ckpt-<step>.msgpack``, as the JAX trainer writes them)."""
    directory = os.path.join(model_root, run)
    return os.path.isdir(directory) and any(
        _CHECKPOINT_FILE.match(p) for p in os.listdir(directory))


def has_trained_params(run, model_root='models'):
    """True when either a checkpoint or a serving artifact exists."""
    return has_checkpoint(run, model_root) or \
        os.path.exists(artifact_path(run))


def restore_for_serving(run, model_root='models', ckpt=None):
    """The trained policy weights of ``<config>/<run>``: ``(PolicyNet
    state_dict, step, 'artifact')``.

    Raises ``NotImplementedError`` when a checkpoint step is asked for
    (``ckpt``) or the run has checkpoints, which the JAX package would
    restore and the port cannot read yet; ``FileNotFoundError`` when there
    is no artifact."""
    if ckpt is not None or has_checkpoint(run, model_root):
        raise NotImplementedError(
            'restoring a training checkpoint (%s, step %s) is not ported '
            'yet: ROADMAP.md item 9c; move the checkpoints away to serve '
            'the artifact %s'
            % (os.path.join(model_root, run), ckpt, artifact_path(run)))
    path = artifact_path(run)
    if not os.path.exists(path):
        raise FileNotFoundError(
            'no checkpoint under %s and no artifact at %s'
            % (os.path.join(model_root, run), path))
    payload = load_artifact(path)
    return (flax_to_state_dict(payload['gen_params']), int(payload['step']),
            'artifact')


class _Reader:
    """A cursor over msgpack bytes."""

    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError('truncated msgpack data')
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]


def _ext(code, payload):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError('unsupported msgpack ext type %d' % code)
    shape, dtype_name, raw = msgpack_restore(bytes(payload))
    arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)
    arr = arr.copy()  # writable, owns its memory
    return arr if code == _EXT_NDARRAY else arr[()]


def _decode(rd):
    b = rd.unpack('B')
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _map(rd, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _array(rd, b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        return bytes(rd.take(b & 0x1f)).decode('utf-8')
    simple = {0xc0: None, 0xc2: False, 0xc3: True}
    if b in simple:
        return simple[b]
    fixed = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
             0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
    if b in fixed:
        return rd.unpack(fixed[b])
    lengths = {0xc4: '>B', 0xc5: '>H', 0xc6: '>I',   # bin
               0xd9: '>B', 0xda: '>H', 0xdb: '>I',   # str
               0xdc: '>H', 0xdd: '>I',               # array
               0xde: '>H', 0xdf: '>I',               # map
               0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}   # ext
    if b in lengths:
        n = rd.unpack(lengths[b])
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(rd.take(n))
        if b in (0xd9, 0xda, 0xdb):
            return bytes(rd.take(n)).decode('utf-8')
        if b in (0xdc, 0xdd):
            return _array(rd, n)
        if b in (0xde, 0xdf):
            return _map(rd, n)
        code = rd.unpack('b')
        return _ext(code, rd.take(n))
    fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
    if b in fixext:
        code = rd.unpack('b')
        return _ext(code, rd.take(fixext[b]))
    raise ValueError('unsupported msgpack type byte 0x%02x' % b)


def _array(rd, n):
    return [_decode(rd) for _ in range(n)]


def _map(rd, n):
    out = {}
    for _ in range(n):
        key = _decode(rd)
        out[key] = _decode(rd)
    return out


def msgpack_restore(data):
    """Decode flax msgpack bytes into dicts, lists and numpy leaves."""
    rd = _Reader(data)
    out = _decode(rd)
    if rd.pos != len(rd.data):
        raise ValueError('trailing bytes after the msgpack object')
    return out


def load_artifact(path):
    """Read a serving artifact: ``{'run', 'step', 'dtype', 'gen_params'}``
    with numpy leaves."""
    with gzip.open(path, 'rb') as f:
        return msgpack_restore(f.read())


def _put(sd, prefix, leaf, conv):
    """One flax layer into ``sd``: conv kernels go from HWIO to OIHW and
    Dense kernels from [in, out] to [out, in]."""
    kernel = np.asarray(leaf['kernel'], np.float32)
    kernel = kernel.transpose(3, 2, 0, 1) if conv else kernel.T
    sd[prefix + '.weight'] = torch.from_numpy(np.array(kernel, order='C'))
    sd[prefix + '.bias'] = torch.from_numpy(
        np.asarray(leaf['bias'], np.float32).copy())


def flax_to_state_dict(gen_params):
    """Map a flax ``PolicyNet`` parameter tree (numpy leaves, with or
    without the top-level ``params`` key) to a ``PolicyNet`` state_dict."""
    tree = gen_params.get('params', gen_params)
    sd = {}
    for name, leaf in tree.items():
        if name in ('shared_extractor', 'selector_extractor'):
            for conv_name, conv_leaf in leaf.items():
                index = int(conv_name.split('_')[1])   # Conv_<i>
                _put(sd, '%s.convs.%d' % (name, index), conv_leaf, conv=True)
        elif name.startswith('filter_'):
            _, j, layer = name.split('_')               # filter_<j>_fc<n>
            _put(sd, 'filter_%s.%d' % (layer, int(j)), leaf, conv=False)
        elif name in ('selector_fc1', 'selector_fc2'):
            _put(sd, name, leaf, conv=False)
        else:
            raise KeyError('unexpected policy parameter %r' % name)
    return sd


def flax_critic_to_state_dict(params):
    """Map a flax ``CriticNet`` parameter tree to a ``CriticNet``
    state_dict.  The flax layers are anonymous, so they map by index:
    ``Conv_<i>`` to ``convs.<i>``, ``Dense_0`` and ``Dense_1`` to ``fc1``
    and ``fc2``."""
    tree = params.get('params', params)
    sd = {}
    for name, leaf in tree.items():
        kind, index = name.split('_')
        if kind == 'Conv':
            _put(sd, 'convs.%d' % int(index), leaf, conv=True)
        elif kind == 'Dense' and index in ('0', '1'):
            _put(sd, 'fc%d' % (int(index) + 1), leaf, conv=False)
        else:
            raise KeyError('unexpected critic parameter %r' % name)
    return sd
