"""Weight importer for the JAX package's serving artifacts.

Serving artifacts and the flax msgpack format (torch counterpart of
``exposure_tpu/core/artifacts.py``).

An artifact is a gzip-compressed flax msgpack map ``{'run', 'step',
'dtype', 'gen_params'}``.  flax writes each array as msgpack ext type 1
whose payload is itself msgpack ``(shape, dtype_name, C-order bytes)``,
and each numpy scalar as ext type 3 with the same payload.  Neither flax
nor the ``msgpack`` package is needed here: ``msgpack_restore`` decodes
and ``msgpack_serialize`` encodes the subset such files use in pure
Python, byte for byte as ``msgpack.packb`` does.  ``flax_to_state_dict``
and ``flax_critic_to_state_dict`` map the flax trees onto
``models.networks.PolicyNet`` and ``CriticNet``; ``state_dict_to_flax`` and
``critic_state_dict_to_flax`` map back (training checkpoints,
``core/checkpoint.py``, use them too).

``restore_for_serving`` is the by-run lookup ``RetouchPipeline.from_run``
and the tools use: the newest training checkpoint under
``models/<config>/<run>`` when there is one, the artifact of
``<config>/<run>`` under ``artifacts/serving/`` otherwise.
``restore_train_state`` reads the evaluator's whole train state from the
same source; ``_source`` alone decides which.
``export_serving_artifact`` writes an artifact from a ``TrainState`` and
``restore_serving_artifact`` reads one back into a template state.
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
    (``model.ckpt-<step>.msgpack``, as either trainer writes them)."""
    directory = os.path.join(model_root, run)
    return os.path.isdir(directory) and any(
        _CHECKPOINT_FILE.match(p) for p in os.listdir(directory))


def _source(run, model_root='models', ckpt=None):
    """Where the trained weights of ``<config>/<run>`` come from, as the JAX
    ``restore_for_serving`` chooses: ``('checkpoint', directory)`` when a
    step ``ckpt`` is asked for or the run has a checkpoint under
    ``model_root``, else ``('artifact', path)`` when its serving artifact
    exists; ``FileNotFoundError`` when there is neither."""
    directory = os.path.join(model_root, run)
    if ckpt is not None or has_checkpoint(run, model_root):
        return 'checkpoint', directory
    path = artifact_path(run)
    if not os.path.exists(path):
        raise FileNotFoundError(
            'no checkpoint under %s and no artifact at %s'
            % (directory, path))
    return 'artifact', path


def has_trained_params(run, model_root='models'):
    """True when either a checkpoint or a serving artifact exists."""
    try:
        _source(run, model_root)
    except FileNotFoundError:
        return False
    return True


def restore_for_serving(run, model_root='models', ckpt=None):
    """The trained policy weights of ``<config>/<run>``: ``(PolicyNet
    state_dict, step, source)``, from the source ``_source`` names (the
    checkpoint at step ``ckpt`` or the newest readable, else the serving
    artifact), as the JAX ``restore_for_serving`` does."""
    from exposure_tpu_torch.core.checkpoint import read_checkpoint
    source, where = _source(run, model_root, ckpt)
    if source == 'checkpoint':
        tree, step = read_checkpoint(where, ckpt)
        return flax_to_state_dict(tree['gen_params']), step, source
    payload = load_artifact(where)
    return (flax_to_state_dict(payload['gen_params']), int(payload['step']),
            source)


def restore_train_state(run, template_state, model_root='models',
                        ckpt=None):
    """The whole ``TrainState`` of ``<config>/<run>``: ``(state, step,
    source)``, as the JAX ``restore_for_serving`` returns it, from the
    source ``_source`` names: the checkpoint restored onto
    ``template_state``, or the template with the serving artifact's
    generator (its critic and value net stay the template's)."""
    from exposure_tpu_torch.core.checkpoint import restore_checkpoint
    source, where = _source(run, model_root, ckpt)
    if source == 'checkpoint':
        state, step = restore_checkpoint(where, template_state, ckpt)
    else:
        state, step = restore_serving_artifact(where, template_state)
    return state, step, source


def export_serving_artifact(run, state, step, path=None, dtype=np.float32):
    """Write the generator-only artifact of a trained ``TrainState``
    (``{'run', 'step', 'dtype', 'gen_params'}``, gzip level 9), as the JAX
    ``export_serving_artifact`` does.  float32 restores bit for bit;
    float16 halves the file and flips near-tie argmax decisions.  Returns
    the path."""
    path = path or artifact_path(run)
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    dtype = np.dtype(dtype)

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return np.asarray(tree, dtype)

    payload = {'run': run, 'step': int(step), 'dtype': dtype.name,
               'gen_params': cast(state_dict_to_flax(state.gen_params))}
    tmp = path + '.tmp'
    with gzip.open(tmp, 'wb', compresslevel=9) as f:
        f.write(msgpack_serialize(payload))
    os.replace(tmp, path)
    return path


def restore_serving_artifact(path, template_state):
    """The template ``TrainState`` with the artifact's generator: ``(state,
    step)``, as the JAX ``restore_serving_artifact``.  The tree and every
    leaf's shape must be the template's (a mismatch raises
    ``ValueError``); the leaves come back as float32 (widened where the
    artifact stored them narrower) on the template's device."""
    payload = load_artifact(path)
    want = state_dict_to_flax(template_state.gen_params)

    def check(tgt, src, at):
        if isinstance(tgt, dict):
            if not isinstance(src, dict) or set(tgt) != set(src):
                raise ValueError('artifact tree mismatch at %s: %s vs %s' % (
                    at or '/', sorted(tgt),
                    sorted(src) if isinstance(src, dict) else type(src)))
            for k in tgt:
                check(tgt[k], src[k], at + '/' + k)
        elif np.shape(src) != np.shape(tgt):
            raise ValueError('artifact leaf %s shape %s != template %s'
                             % (at, np.shape(src), np.shape(tgt)))
    check(want, payload['gen_params'], '')
    device = next(iter(template_state.gen_params.values())).device
    gen = {k: v.to(device) for k, v in
           flax_to_state_dict(payload['gen_params']).items()}
    return template_state.replace(gen_params=gen), int(payload['step'])


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


def _header(out, n, fix, fix_max, codes):
    """A length header: ``fix | n`` below ``fix_max``, else the first code
    of ``codes`` ((code, struct format, limit), ...) whose limit takes it."""
    if fix is not None and n < fix_max:
        out.append(struct.pack('B', fix | n))
        return
    for code, fmt, limit in codes:
        if n < limit:
            out.append(struct.pack('>B' + fmt, code, n))
            return
    raise ValueError('msgpack length %d too large' % n)


_STR = ((0xd9, 'B', 1 << 8), (0xda, 'H', 1 << 16), (0xdb, 'I', 1 << 32))
_BIN = ((0xc4, 'B', 1 << 8), (0xc5, 'H', 1 << 16), (0xc6, 'I', 1 << 32))
_ARRAY = ((0xdc, 'H', 1 << 16), (0xdd, 'I', 1 << 32))
_MAP = ((0xde, 'H', 1 << 16), (0xdf, 'I', 1 << 32))
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
_EXT = ((0xc7, 'B', 1 << 8), (0xc8, 'H', 1 << 16), (0xc9, 'I', 1 << 32))


def _int(out, n):
    if 0 <= n < 0x80 or -32 <= n < 0:
        out.append(struct.pack('b' if n < 0 else 'B', n))
        return
    codes = ((0xcc, 'B', 0, 1 << 8), (0xcd, 'H', 0, 1 << 16),
             (0xce, 'I', 0, 1 << 32), (0xcf, 'Q', 0, 1 << 64)) if n > 0 \
        else ((0xd0, 'b', -(1 << 7), 0), (0xd1, 'h', -(1 << 15), 0),
              (0xd2, 'i', -(1 << 31), 0), (0xd3, 'q', -(1 << 63), 0))
    for code, fmt, lo, hi in codes:
        if lo <= n < hi:
            out.append(struct.pack('>B' + fmt, code, n))
            return
    raise ValueError('integer %d does not fit msgpack' % n)


def _ext_out(out, code, payload):
    if len(payload) in _FIXEXT:
        out.append(struct.pack('>Bb', _FIXEXT[len(payload)], code))
    else:
        _header(out, len(payload), None, 0, _EXT)
        out.append(struct.pack('b', code))
    out.append(payload)


def _encode(out, obj):
    if obj is None:
        out.append(b'\xc0')
    elif obj is True or obj is False:
        out.append(b'\xc3' if obj else b'\xc2')
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(struct.pack('>Bd', 0xcb, obj))
    elif isinstance(obj, str):
        raw = obj.encode('utf-8')
        _header(out, len(raw), 0xa0, 32, _STR)
        out.append(raw)
    elif isinstance(obj, bytes):
        _header(out, len(obj), None, 0, _BIN)
        out.append(obj)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, _MAP)
        for key, value in obj.items():
            _encode(out, key)
            _encode(out, value)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, _ARRAY)
        for value in obj:
            _encode(out, value)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject:
            raise ValueError('object arrays do not serialize')
        payload = msgpack_serialize(
            (list(arr.shape), arr.dtype.name, arr.tobytes('C')))
        _ext_out(out, _EXT_NDARRAY if isinstance(obj, np.ndarray)
                 else _EXT_NPSCALAR, payload)
    else:
        raise TypeError('cannot serialize %r' % type(obj))


def msgpack_serialize(tree):
    """Encode dicts, lists, python scalars and numpy leaves as flax's
    ``msgpack_serialize`` does (``msgpack.packb`` with flax's ext types:
    each array ext type 1, each numpy scalar ext type 3, with the payload
    ``(shape, dtype_name, C-order bytes)``), in the dicts' key order."""
    out = []
    _encode(out, tree)
    return b''.join(out)


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


def sorted_tree(tree):
    """``tree`` with every dict's keys in sorted order, as a JAX tree map
    leaves a flax parameter tree (and so the JAX package writes them)."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def _layer(sd, prefix, conv):
    """One layer of a state_dict as a flax leaf: conv weights from OIHW to
    HWIO, linear weights from [out, in] to [in, out]."""
    weight = sd[prefix + '.weight'].detach().cpu().numpy().astype(np.float32)
    kernel = weight.transpose(2, 3, 1, 0) if conv else weight.T
    return {'bias': sd[prefix + '.bias'].detach().cpu().numpy()
            .astype(np.float32),
            'kernel': np.ascontiguousarray(kernel)}


def _indices(sd, prefix, at):
    return sorted({int(k.split('.')[at]) for k in sd if k.startswith(prefix)})


def state_dict_to_flax(sd):
    """Inverse of :func:`flax_to_state_dict`: a ``PolicyNet`` state_dict
    (or a tree of Adam moments keyed alike) as the flax ``{'params': ...}``
    tree, numpy leaves, keys sorted."""
    params = {}
    for name in ('shared_extractor', 'selector_extractor'):
        params[name] = {
            'Conv_%d' % i: _layer(sd, '%s.convs.%d' % (name, i), conv=True)
            for i in _indices(sd, name + '.convs.', 2)}
    for j in _indices(sd, 'filter_fc1.', 1):
        for layer in ('fc1', 'fc2'):
            params['filter_%d_%s' % (j, layer)] = _layer(
                sd, 'filter_%s.%d' % (layer, j), conv=False)
    for name in ('selector_fc1', 'selector_fc2'):
        params[name] = _layer(sd, name, conv=False)
    return sorted_tree({'params': params})


def critic_state_dict_to_flax(sd):
    """Inverse of :func:`flax_critic_to_state_dict` (the critic and the
    value network)."""
    params = {'Conv_%d' % i: _layer(sd, 'convs.%d' % i, conv=True)
              for i in _indices(sd, 'convs.', 1)}
    params['Dense_0'] = _layer(sd, 'fc1', conv=False)
    params['Dense_1'] = _layer(sd, 'fc2', conv=False)
    return sorted_tree({'params': params})


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
