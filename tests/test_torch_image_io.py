"""The port's image IO against ``imageio`` and the JAX package's
``utils/image_io.py``:

- the PNG codec (zlib, struct and numpy alone): what ``write_png`` writes,
  ``imageio`` decodes to the same array, byte for byte, at 8 and 16 bits
  (``cv2`` for 16-bit colour, which Pillow reduces to 8 bits);
  what ``imageio`` writes, and files encoded here with each of the five
  scanline filters (and a mix of them), a palette, an alpha channel or
  fewer than 8 bits, ``read_png`` decodes to what ``imageio`` decodes;
- ``read_image`` / ``write_image`` equal the JAX package's on the same
  files (exactly: the quantisation is ``clip(x * 255, 0, 255)`` truncated);
- the colour functions within 1e-6 (they are the same numpy code), the
  centre crop and the image grid exactly;
- other formats name ``imageio`` when it is missing, and the module imports
  with ``imageio``, ``cv2`` and PIL hidden."""

import os
import struct
import subprocess
import sys
import textwrap
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from exposure_tpu.utils import image_io as jio
from exposure_tpu_torch.utils import image_io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = [os.path.join(REPO, 'docs', 'sample_inputs', 'masked%d.png' % i)
           for i in range(3)]


def _decode(path):
    """A PNG decoded by a library: ``imageio`` (Pillow) at 8 bits and for
    16-bit gray; Pillow reduces 16-bit colour to 8 bits, so those files go
    through ``cv2``, which keeps the 16 bits (BGR order, and gray + alpha
    expanded to four channels)."""
    img = np.asarray(imageio.imread(path))
    with open(path, 'rb') as f:
        depth, color = struct.unpack('>BB', f.read(26)[24:26])
    if depth != 16 or color == 0:
        return img
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert img.dtype == np.uint16
    if color == 4:
        return img[..., [0, 3]]
    return img[..., [2, 1, 0, 3][:img.shape[2]]]


def _filter_rows(rows, bpp, kinds):
    """PNG-filter [H, row_bytes] uint8 rows, row y with type kinds[y]."""
    h, n = rows.shape
    out = np.zeros((h, n + 1), np.uint8)
    prev = np.zeros(n, np.int32)
    for y in range(h):
        cur = rows[y].astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        kind = kinds[y]
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out[y, 0] = kind
        out[y, 1:] = (cur - pred) & 255
        prev = cur
    return out


def _chunk(kind, payload):
    return (struct.pack('>I', len(payload)) + kind + payload +
            struct.pack('>I', zlib.crc32(kind + payload)))


def _encode(path, rows, width, depth, color, bpp, kinds, extra=b'',
            split=None):
    """A PNG file from packed rows; ``split`` cuts IDAT into two chunks."""
    data = zlib.compress(_filter_rows(rows, bpp, kinds).tobytes(), 6)
    idat = _chunk(b'IDAT', data) if split is None else \
        _chunk(b'IDAT', data[:split]) + _chunk(b'IDAT', data[split:])
    with open(path, 'wb') as f:
        f.write(tio.PNG_SIGNATURE + _chunk(b'IHDR', struct.pack(
            '>IIBBBBB', width, rows.shape[0], depth, color, 0, 0, 0)) +
            extra + idat + _chunk(b'IEND', b''))


def _rows_of(arr):
    """[H, W(, C)] uint8 or uint16 -> packed big-endian [H, row_bytes]."""
    if arr.dtype == np.uint16:
        arr = arr.astype('>u2')
    return np.ascontiguousarray(arr).view(np.uint8).reshape(arr.shape[0], -1)


@pytest.mark.parametrize('dtype', ['uint8', 'uint16'])
@pytest.mark.parametrize('shape', [(37, 53, 3), (16, 16), (5, 7, 4),
                                   (9, 4, 2), (300, 452, 3)])
def test_write_png_decodes_in_imageio(tmp_path, dtype, shape):
    rng = np.random.RandomState(len(shape) + shape[0])
    top = 255 if dtype == 'uint8' else 65535
    arr = rng.randint(0, top + 1, shape).astype(dtype)
    path = str(tmp_path / 'a.png')
    tio.write_png(path, arr)
    back = _decode(path)
    assert back.dtype == arr.dtype and back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)
    mine = tio.read_png(path)
    assert mine.dtype == arr.dtype
    np.testing.assert_array_equal(mine, arr)


@pytest.mark.parametrize('kinds', [0, 1, 2, 3, 4, 'mixed', 'no_paeth'])
@pytest.mark.parametrize('fmt', ['rgb8', 'rgb16', 'gray8', 'gray16', 'rgba8',
                                 'rgba16'])
def test_read_png_every_scanline_filter(tmp_path, kinds, fmt):
    """Files encoded here with one filter on every line, with all five in
    turn and with the three that do not need the diagonal pass."""
    channels = {'rgb': 3, 'gray': 1, 'rgba': 4}[fmt.rstrip('0123456789')]
    depth = int(fmt[len(fmt.rstrip('0123456789')):])
    color = {1: 0, 3: 2, 4: 6}[channels]
    h, w = 23, 31
    rng = np.random.RandomState(depth + channels)
    # smooth content plus noise, so every Paeth branch is taken
    top = (1 << depth) - 1
    ramp = np.linspace(0, top, w)[None, :, None] * np.ones((h, 1, channels))
    arr = np.clip(ramp + rng.randint(-40, 41, (h, w, channels)) *
                  (top // 255), 0, top).astype(
                      np.uint8 if depth == 8 else np.uint16)
    if channels == 1:
        arr = arr[:, :, 0]
    if kinds == 'mixed':
        row_kinds = [y % 5 for y in range(h)]
    elif kinds == 'no_paeth':
        row_kinds = [y % 3 for y in range(h)]
    else:
        row_kinds = [kinds] * h
    path = str(tmp_path / 'f.png')
    _encode(path, _rows_of(arr), w, depth, color, channels * depth // 8,
            row_kinds, split=40)
    want = _decode(path)
    np.testing.assert_array_equal(want, arr)    # the encoder above is sound
    got = tio.read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('depth', [1, 2, 4, 8])
@pytest.mark.parametrize('trns', [False, True])
def test_read_png_palette(tmp_path, depth, trns):
    h, w = 11, 13                    # a width that leaves a ragged last byte
    rng = np.random.RandomState(depth)
    n = 1 << depth
    palette = rng.randint(0, 256, (n, 3)).astype(np.uint8)
    index = rng.randint(0, n, (h, w)).astype(np.uint8)
    bits = np.unpackbits(index[:, :, None], axis=2)[:, :, 8 - depth:]
    rows = np.packbits(bits.reshape(h, -1), axis=1)
    extra = _chunk(b'PLTE', palette.tobytes())
    if trns:
        extra += _chunk(b'tRNS', bytes(rng.randint(0, 256, n // 2 + 1)
                                       .astype(np.uint8)))
    path = str(tmp_path / 'p.png')
    _encode(path, rows, w, depth, 3, 1, [y % 5 for y in range(h)], extra)
    want = np.asarray(imageio.imread(path))
    got = tio.read_png(path)
    assert got.shape == want.shape == (h, w, 3)   # tRNS is not read
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., :3], palette[index])
    np.testing.assert_array_equal(tio.read_image(path), jio.read_image(path))


@pytest.mark.parametrize('depth', [1, 2, 4])
def test_read_png_low_bit_gray(tmp_path, depth):
    """Gray below 8 bits reads as the JAX package reads it through imageio:
    the same float image."""
    h, w = 9, 21
    rng = np.random.RandomState(depth)
    gray = rng.randint(0, 1 << depth, (h, w)).astype(np.uint8)
    bits = np.unpackbits(gray[:, :, None], axis=2)[:, :, 8 - depth:]
    rows = np.packbits(bits.reshape(h, -1), axis=1)
    path = str(tmp_path / 'g.png')
    _encode(path, rows, w, depth, 0, 1, [y % 5 for y in range(h)])
    np.testing.assert_array_equal(
        tio.read_png(path), gray.astype(np.uint16) * 255 // ((1 << depth) - 1))
    np.testing.assert_array_equal(tio.read_image(path), jio.read_image(path))


@pytest.mark.parametrize('path', SAMPLES)
def test_sample_inputs_read_and_write_as_the_jax_package(tmp_path, path):
    want = jio.read_image(path)
    got = tio.read_image(path)
    assert got.dtype == np.float32 and got.shape == want.shape == (512, 512,
                                                                   3)
    np.testing.assert_array_equal(got, want)
    # the same float image, off the 8-bit grid, written by both
    img = want ** 2.2 * 1.3 - 0.05
    a, b = str(tmp_path / 'a.png'), str(tmp_path / 'b.png')
    tio.write_image(a, img)
    jio.write_image(b, img)
    np.testing.assert_array_equal(np.asarray(imageio.imread(a)),
                                  np.asarray(imageio.imread(b)))
    np.testing.assert_array_equal(tio.read_png(a), tio.read_png(b))
    np.testing.assert_array_equal(
        tio.read_png(a), np.clip(img * 255.0, 0, 255).astype(np.uint8))


def test_files_written_by_imageio(tmp_path):
    rng = np.random.RandomState(3)
    for name, arr in (
            ('rgb8', rng.randint(0, 256, (40, 50, 3)).astype(np.uint8)),
            ('gray16', rng.randint(0, 65536, (40, 50)).astype(np.uint16)),
            ('rgba8', rng.randint(0, 256, (33, 17, 4)).astype(np.uint8)),
            ('smooth', (np.add.outer(np.arange(64), np.arange(64))[..., None]
                        * np.ones(3)).astype(np.uint8))):
        path = str(tmp_path / (name + '.png'))
        imageio.imwrite(path, arr)
        np.testing.assert_array_equal(tio.read_png(path), arr)
        np.testing.assert_array_equal(tio.read_image(path),
                                      jio.read_image(path))


def test_png_faults_raise(tmp_path):
    arr = np.zeros((4, 4, 3), np.uint8)
    path = str(tmp_path / 'x.png')
    tio.write_png(path, arr)
    data = bytearray(open(path, 'rb').read())
    data[40] ^= 1                               # inside IDAT
    bad = str(tmp_path / 'bad.png')
    open(bad, 'wb').write(bytes(data))
    with pytest.raises(ValueError, match='CRC'):
        tio.read_png(bad)
    inter = str(tmp_path / 'i.png')
    open(inter, 'wb').write(
        tio.PNG_SIGNATURE + _chunk(b'IHDR', struct.pack(
            '>IIBBBBB', 4, 4, 8, 2, 0, 0, 1)) +
        _chunk(b'IDAT', zlib.compress(bytes(4 * 13))) + _chunk(b'IEND', b''))
    with pytest.raises(ValueError, match='interlaced'):
        tio.read_png(inter)
    with pytest.raises(ValueError, match='signature'):
        tio.read_png(__file__)
    with pytest.raises(ValueError, match='write_png takes'):
        tio.write_png(path, np.zeros((4, 4, 3), np.float32))


def test_other_formats_go_to_imageio_or_name_it(tmp_path, monkeypatch):
    img = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    tif = str(tmp_path / 'a.tif')
    imageio.imwrite(tif, (img * 65535).astype(np.uint16))
    np.testing.assert_array_equal(tio.read_tiff16(tif), jio.read_tiff16(tif))
    np.testing.assert_array_equal(tio.read_image(tif), jio.read_image(tif))
    jpg = str(tmp_path / 'b.jpg')
    imageio.imwrite(jpg, (img * 255).astype(np.uint8))
    np.testing.assert_array_equal(tio.read_image(jpg), jio.read_image(jpg))
    want = tio.read_tiff16(tif)
    monkeypatch.setitem(sys.modules, 'imageio', None)
    monkeypatch.setitem(sys.modules, 'imageio.v2', None)
    with pytest.raises(RuntimeError, match='imageio'):
        tio.read_image(jpg)
    # a baseline TIFF needs no package either (the port's own reader)
    np.testing.assert_array_equal(tio.read_tiff16(tif), want)
    with pytest.raises(RuntimeError, match='imageio'):
        tio.write_image(str(tmp_path / 'a.jpg'), img)
    png = str(tmp_path / 'a.png')
    tio.write_image(png, img)                   # PNG needs no package
    assert tio.read_image(png).shape == (8, 8, 3)


def test_colour_functions_match(rng):
    """The same numpy code on both sides: within 1e-6 (they agree
    exactly)."""
    img = rng.rand(6, 5, 3)
    for reverse in (False, True):
        np.testing.assert_allclose(
            tio.linearize_prophoto_rgb(img, reverse),
            jio.linearize_prophoto_rgb(img, reverse), rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            tio.prophoto_rgb_to_xyz(img, reverse),
            jio.prophoto_rgb_to_xyz(img, reverse), rtol=0, atol=1e-6)
    for pair in (('D65', 'D50'), ('D50', 'D65')):
        np.testing.assert_allclose(tio.xyz_chromatic_adapt(img, *pair),
                                   jio.xyz_chromatic_adapt(img, *pair),
                                   rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        tio.xyz_chromatic_adapt(img, 'D50', 'D50')
    for linear in (False, True):
        np.testing.assert_allclose(tio.prophoto_rgb_to_lab(img, linear),
                                   jio.prophoto_rgb_to_lab(img, linear),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize('shape', [(10, 16, 3), (16, 10, 3), (9, 9, 3),
                                   (11, 16, 3)])
def test_centre_crop_and_grid_match(rng, shape):
    img = rng.rand(*shape).astype(np.float32)
    np.testing.assert_array_equal(tio.get_image_center(img),
                                  jio.get_image_center(img))
    batch = rng.rand(8, 6, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(tio.make_image_grid(batch, per_row=4),
                                  jio.make_image_grid(batch, per_row=4))


def test_image_io_imports_with_no_image_package():
    code = textwrap.dedent('''
        import sys
        for name in ('imageio', 'cv2', 'PIL', 'jax', 'flax'):
            sys.modules[name] = None
        import numpy as np
        from exposure_tpu_torch.utils import image_io
        image_io.write_image(sys.argv[1], np.full((3, 5, 3), 0.5))
        back = image_io.read_image(sys.argv[1])
        assert back.shape == (3, 5, 3) and abs(back - 127 / 255).max() < 1e-7
        print('ok')
    ''')
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        proc = subprocess.run(
            [sys.executable, '-c', code, os.path.join(d, 'a.png')], cwd=REPO,
            capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == 'ok', \
        proc.stderr[-2000:]
