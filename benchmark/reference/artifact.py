"""Reads a flax serving artifact (a gzip-compressed msgpack map whose arrays
are ext type 1 records of ``(shape, dtype name, C-order bytes)``) into
nested dicts of numpy arrays, for the reference's weights.  Written for
the benchmark from the msgpack specification; the program's reader is not
used."""

import gzip
import hashlib
import struct

import numpy as np

_FIXED = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
          0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
_LEN = {0xc4: '>B', 0xc5: '>H', 0xc6: '>I', 0xd9: '>B', 0xda: '>H',
        0xdb: '>I', 0xdc: '>H', 0xdd: '>I', 0xde: '>H', 0xdf: '>I',
        0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _unpack(buf, pos):
    """``(value, next position)`` of the msgpack object at ``pos``."""
    b = buf[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        return _map(buf, pos, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _list(buf, pos, b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return bytes(buf[pos:pos + n]).decode('utf-8'), pos + n
    if b in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[b], pos
    if b in _FIXED:
        size = struct.calcsize(_FIXED[b])
        return struct.unpack_from(_FIXED[b], buf, pos)[0], pos + size
    if b in _LEN:
        fmt = _LEN[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(buf[pos:pos + n]), pos + n
        if b in (0xd9, 0xda, 0xdb):
            return bytes(buf[pos:pos + n]).decode('utf-8'), pos + n
        if b in (0xdc, 0xdd):
            return _list(buf, pos, n)
        if b in (0xde, 0xdf):
            return _map(buf, pos, n)
        code = struct.unpack_from('b', buf, pos)[0]
        return _ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n
    if b in _FIXEXT:
        n = _FIXEXT[b]
        code = struct.unpack_from('b', buf, pos)[0]
        return _ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n
    raise ValueError('msgpack type byte 0x%02x not supported' % b)


def _list(buf, pos, n):
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos)
        out.append(v)
    return out, pos


def _map(buf, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos


def _ext(code, payload):
    if code not in (1, 2):
        raise ValueError('msgpack ext type %d not supported' % code)
    (shape, dtype, raw), _ = _unpack(memoryview(bytes(payload)), 0)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
    return arr if code == 1 else arr[()]


def sha256(path):
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        for block in iter(lambda: f.read(1 << 20), b''):
            h.update(block)
    return h.hexdigest()


def load(path):
    """The artifact's top-level map, arrays as numpy."""
    with gzip.open(path, 'rb') as f:
        data = memoryview(f.read())
    value, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError('trailing bytes in %s' % path)
    return value
