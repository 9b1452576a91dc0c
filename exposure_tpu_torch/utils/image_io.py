"""Image IO and colour science on the host (numpy), the counterpart of
``exposure_tpu/utils/image_io.py``.

PNG files are read and written by the codec in this module, which needs
``zlib``, ``struct`` and numpy only, so the port reads and writes the same
bytes wherever it runs.  ``read_png`` takes non-interlaced files of every
colour type (gray, RGB, palette, gray + alpha, RGBA) at 1 to 16 bits with
all five scanline filters; ``write_png`` writes 8-bit and 16-bit gray, RGB
and RGBA with filter 0 on every line.  A file is a PNG when it starts with
the PNG signature (reading) or its name ends in ``.png`` (writing).
``read_tiff`` reads baseline TIFF files (strips, chunky gray or RGB, 8 or
16 bits, either byte order, uncompressed or deflate), which is what the
FiveK Lightroom exports are.  Any other format (``.jpg``, a tiled or LZW
TIFF) goes to ``imageio``, imported when it is needed; without that
package the call raises an error that names it.

The rest is the JAX package's numpy code: the centre crop, the image grid
and the ProPhotoRGB/XYZ/Lab pipeline.
"""

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# colour type -> samples per pixel
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _imageio(path):
    try:
        import imageio.v2 as imageio
    except ImportError:
        raise RuntimeError(
            '%s is neither a PNG nor a baseline TIFF: reading or writing it '
            'needs the imageio package, which is not installed'
            % path) from None
    return imageio


def _chunks(data, path):
    """``(type, payload)`` of each chunk, CRC checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError('%s does not start with the PNG signature' % path)
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError('%s: truncated PNG chunk header' % path)
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError('%s: truncated %r chunk' % (path, kind))
        payload = data[pos + 8:end]
        crc, = struct.unpack('>I', data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError('%s: bad CRC in %r chunk' % (path, kind))
        yield kind, payload
        pos = end + 4


def _paeth(a, b, c):
    """The Paeth predictor on int16 arrays: whichever of left ``a``, up
    ``b`` and up-left ``c`` is nearest to a + b - c, ties in that order."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filt, lines, bpp):
    """Undo the scanline filters.

    ``filt``: [H] filter types; ``lines``: [H, row_bytes] filtered bytes;
    ``bpp``: bytes per complete pixel (at least 1).  Returns the [H,
    row_bytes] bytes of the image.

    Without the Average and Paeth filters a line needs only the finished
    line above and a running sum along itself, so lines are undone one by
    one.  Average and Paeth need the finished pixel to the left too; then
    the image is undone along its anti-diagonals, each of whose pixels
    depends on the two diagonals before it and on nothing else, so one
    numpy pass serves a whole diagonal."""
    h, row_bytes = lines.shape
    if filt.max(initial=0) > 4:
        raise ValueError('PNG scanline filter type %d' % filt.max())
    pad = -row_bytes % bpp
    n = (row_bytes + pad) // bpp
    x = np.zeros((h, n * bpp), np.uint8)
    x[:, :row_bytes] = lines
    x = x.reshape(h, n, bpp)
    if filt.max(initial=0) <= 2:
        prev = np.zeros((n, bpp), np.uint8)
        for y in range(h):
            if filt[y] == 1:
                x[y] = np.add.accumulate(x[y], axis=0, dtype=np.uint8)
            elif filt[y] == 2:
                x[y] += prev
            prev = x[y]
        return x.reshape(h, n * bpp)[:, :row_bytes]
    # out[y + 1, x + 1] is pixel (y, x); row 0 and column 0 are the zeros
    # the filters see outside the image
    out = np.zeros((h + 1, n + 1, bpp), np.int16)
    src = x.astype(np.int16)
    kind = filt.astype(np.int16)
    for d in range(h + n - 1):
        ys = np.arange(max(0, d - n + 1), min(h - 1, d) + 1)
        xs = d - ys
        a, b, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        t = kind[ys][:, None]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, _paeth(a, b, c), 0))))
        out[ys + 1, xs + 1] = (src[ys, xs] + pred) & 255
    return out[1:, 1:].astype(np.uint8).reshape(h, n * bpp)[:, :row_bytes]


def read_png(path):
    """Decode a non-interlaced PNG: uint8, or uint16 for 16-bit files, of
    shape [H, W] (gray), [H, W, 2] (gray + alpha), [H, W, 3] or [H, W, 4].
    A palette file comes back as the RGB of its entries (a tRNS chunk is
    not read: ``read_image`` drops alpha anyway); gray below 8 bits is
    scaled to 0..255."""
    with open(path, 'rb') as f:
        data = f.read()
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data, path):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', payload)
        elif kind == b'PLTE':
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b'IDAT':
            idat.append(payload)
        elif kind == b'IEND':
            break
    if header is None or not idat:
        raise ValueError('%s: no IHDR or no IDAT chunk' % path)
    width, height, depth, color, compression, filtering, interlace = header
    if color not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16) or \
            compression or filtering:
        raise ValueError('%s: unsupported PNG header %r' % (path, header))
    if interlace:
        raise ValueError('%s: interlaced PNG files are not read' % path)
    channels = _PNG_CHANNELS[color]
    if depth < 8 and color not in (0, 3) or depth == 16 and color == 3:
        raise ValueError('%s: bit depth %d with colour type %d'
                         % (path, depth, color))
    row_bytes = (width * channels * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if raw.size != height * (row_bytes + 1):
        raise ValueError('%s: %d bytes of image data, expected %d'
                         % (path, raw.size, height * (row_bytes + 1)))
    raw = raw.reshape(height, row_bytes + 1)
    rows = _unfilter(raw[:, 0], raw[:, 1:], max(channels * depth // 8, 1))
    if depth == 16:
        img = np.ascontiguousarray(rows).view('>u2').astype(np.uint16)
    elif depth == 8:
        img = rows
    else:   # 1, 2 or 4 bits: the leftmost pixel in the high bits
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        img = bits.dot(1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        img = img[:, :width]
        if color == 0:
            img = (img.astype(np.uint16) * 255 // ((1 << depth) - 1)
                   ).astype(np.uint8)
    img = img.reshape(height, width, channels)
    if color == 3:
        if palette is None or img.max(initial=0) >= len(palette):
            raise ValueError('%s: palette missing or too short' % path)
        return palette[img[:, :, 0]]
    return img[:, :, 0] if channels == 1 else img


def _chunk(kind, payload):
    return (struct.pack('>I', len(payload)) + kind + payload +
            struct.pack('>I', zlib.crc32(kind + payload)))


def write_png(path, arr):
    """Write a uint8 or uint16 array of shape [H, W], [H, W, 1] (gray),
    [H, W, 2] (gray + alpha), [H, W, 3] (RGB) or [H, W, 4] (RGBA) as a
    non-interlaced PNG, filter 0 on every line, zlib's default level."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in _PNG_COLOR_TYPE or \
            arr.dtype not in (np.uint8, np.uint16) or 0 in arr.shape:
        raise ValueError('write_png takes uint8 or uint16 [H, W] or '
                         '[H, W, 1..4], got %s %s' % (arr.dtype, arr.shape))
    height, width, channels = arr.shape
    depth = 8 * arr.dtype.itemsize
    lines = np.ascontiguousarray(arr.astype('>u2') if depth == 16 else arr)
    lines = lines.view(np.uint8).reshape(height, -1)
    raw = np.zeros((height, lines.shape[1] + 1), np.uint8)
    raw[:, 1:] = lines
    header = struct.pack('>IIBBBBB', width, height, depth,
                         _PNG_COLOR_TYPE[channels], 0, 0, 0)
    with open(path, 'wb') as f:
        f.write(PNG_SIGNATURE + _chunk(b'IHDR', header) +
                _chunk(b'IDAT', zlib.compress(raw.tobytes())) +
                _chunk(b'IEND', b''))


class TiffNotRead(ValueError):
    """A TIFF feature outside the baseline subset ``read_tiff`` reads."""


# TIFF field types -> (numpy code, bytes): BYTE, ASCII, SHORT, LONG
_TIFF_TYPES = {1: ('u1', 1), 2: ('u1', 1), 3: ('u2', 2), 4: ('u4', 4)}


def _tiff_tags(data, path):
    """``(byte order, {tag: tuple of values})`` of a TIFF's first image."""
    order = {b'II': '<', b'MM': '>'}.get(data[:2])
    if order is None or struct.unpack(order + 'H', data[2:4])[0] != 42:
        raise TiffNotRead('%s is not a classic TIFF' % path)
    ifd, = struct.unpack(order + 'I', data[4:8])
    count, = struct.unpack(order + 'H', data[ifd:ifd + 2])
    tags = {}
    for k in range(count):
        pos = ifd + 2 + 12 * k
        tag, kind, n = struct.unpack(order + 'HHI', data[pos:pos + 8])
        if kind not in _TIFF_TYPES:
            continue        # rationals and the rest: nothing read needs them
        code, size = _TIFF_TYPES[kind]
        if n * size > 4:
            pos, = struct.unpack(order + 'I', data[pos + 8:pos + 12])
        else:
            pos += 8
        tags[tag] = tuple(int(v) for v in np.frombuffer(
            data, order + code, n, pos))
    return order, tags


def read_tiff(path):
    """Decode a baseline TIFF's first image: strips, chunky gray or RGB
    (an extra alpha sample is kept), unsigned 8 or 16 bits, either byte
    order, no compression or deflate, with or without the horizontal
    predictor.  Returns uint8 or uint16 of shape [H, W] or [H, W, C].
    Anything else raises ``TiffNotRead``."""
    with open(path, 'rb') as f:
        data = f.read()
    order, tags = _tiff_tags(data, path)

    def one(tag, default=None):
        values = tags.get(tag, (default,))
        if values[0] is None:
            raise TiffNotRead('%s: no TIFF tag %d' % (path, tag))
        return values[0]

    width, height = one(256), one(257)
    channels = one(277, 1)
    depth = set(tags.get(258, (1,)))
    compression, predictor = one(259, 1), one(317, 1)
    if len(depth) != 1 or depth.pop() not in (8, 16) or \
            one(262) not in (0, 1, 2) or one(284, 1) != 1 or \
            compression not in (1, 8, 32946) or predictor not in (1, 2) or \
            set(tags.get(339, (1,))) != {1} or 322 in tags:
        raise TiffNotRead('%s: not a baseline strip TIFF of unsigned 8 or '
                          '16-bit chunky samples, uncompressed or deflate'
                          % path)
    dtype = np.dtype(order + ('u1' if one(258) == 8 else 'u2'))
    rows_per_strip = min(one(278, height), height)
    strips = []
    for offset, n in zip(tags[273], tags[279]):
        strip = data[offset:offset + n]
        strips.append(zlib.decompress(strip) if compression != 1 else strip)
    row_bytes = width * channels * dtype.itemsize
    out = np.empty((height, width * channels), dtype)
    for s, strip in enumerate(strips):
        top = s * rows_per_strip
        rows = min(rows_per_strip, height - top)
        if rows <= 0:
            break
        out[top:top + rows] = np.frombuffer(
            strip, dtype, rows * row_bytes // dtype.itemsize).reshape(rows, -1)
    out = out.reshape(height, width, channels)
    if predictor == 2:      # each sample stored as a difference to its left
        out = np.cumsum(out, axis=1, dtype=dtype)
    out = out.astype(dtype.newbyteorder('='))
    if one(262) == 0:       # WhiteIsZero
        out = np.iinfo(out.dtype).max - out
    return out[:, :, 0] if channels == 1 else out


def _signature(path):
    with open(path, 'rb') as f:
        return f.read(8)


def _read_array(path):
    head = _signature(path)
    if head == PNG_SIGNATURE:
        return read_png(path)
    if head[:4] in (b'II*\0', b'MM\0*'):
        try:
            return read_tiff(path)
        except TiffNotRead:
            pass
    return np.asarray(_imageio(path).imread(path))


def read_image(path):
    """Read any 8/16-bit image to float32 RGB in [0, 1] (an alpha channel
    is dropped, gray is repeated over the three channels)."""
    img = _read_array(path)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    elif img.dtype == np.uint16:
        img = img.astype(np.float32) / 65535.0
    else:
        img = img.astype(np.float32)
    if img.ndim == 3 and img.shape[2] == 2:     # gray + alpha
        img = img[..., 0]
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


def read_tiff16(path):
    """16-bit TIFF -> float32 in [0, 1]."""
    img = _read_array(path)
    depth = 8 if img.dtype == np.uint8 else 16
    return (img.astype(np.float32) * (1.0 / (2 ** depth - 1)))


def write_image(path, img):
    """Save a float [0, 1] RGB image in 8 bits: ``clip(img * 255, 0,
    255)``, truncated, as the JAX package writes it."""
    arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    if str(path).lower().endswith('.png'):
        write_png(path, arr)
    else:
        _imageio(path).imwrite(path, arr)


def linearize_prophoto_rgb(pp_rgb, reverse=False):
    """Undo (or redo) the ProPhotoRGB gamma-1.8 encode."""
    gamma = 1.8 if not reverse else 1.0 / 1.8
    return np.power(pp_rgb, gamma)


_PROPHOTO_TO_XYZ = np.array(
    [[0.7976749, 0.1351917, 0.0313534],
     [0.2880402, 0.7118741, 0.0000857],
     [0.0000000, 0.0000000, 0.8252100]], dtype=np.float64)

_XYZ_TO_PROPHOTO = np.array(
    [[1.34594337, -0.25560752, -0.05111183],
     [-0.54459882, 1.5081673, 0.02053511],
     [0.0, 0.0, 1.21181275]], dtype=np.float64)

_D65_TO_D50 = np.array(
    [[1.0478112, 0.0228866, -0.0501270],
     [0.0295424, 0.9904844, -0.0170491],
     [-0.0092345, 0.0150436, 0.7521316]], dtype=np.float64)

_D50_TO_D65 = np.array(
    [[0.9555766, -0.0230393, 0.0631636],
     [-0.0282895, 1.0099416, 0.0210077],
     [0.0122982, -0.0204830, 1.3299098]], dtype=np.float64)


def _apply_matrix(img, mat):
    sp = img.shape
    flat = img.reshape(-1, 3) @ mat.T
    return flat.reshape(sp)


def prophoto_rgb_to_xyz(pp_rgb, reverse=False):
    """Linear ProPhotoRGB (D50) <-> XYZ."""
    mat = _XYZ_TO_PROPHOTO if reverse else _PROPHOTO_TO_XYZ
    return _apply_matrix(pp_rgb, mat)


def xyz_chromatic_adapt(xyz, src_white='D65', dest_white='D50'):
    """Bradford-style chromatic adaptation."""
    if (src_white, dest_white) == ('D65', 'D50'):
        mat = _D65_TO_D50
    elif (src_white, dest_white) == ('D50', 'D65'):
        mat = _D50_TO_D65
    else:
        raise ValueError('unsupported white pair %s -> %s' %
                         (src_white, dest_white))
    return _apply_matrix(xyz, mat)


def _xyz_to_lab(xyz):
    # CIE Lab with D65 reference white
    white = np.array([0.95047, 1.0, 1.08883])
    t = xyz / white
    delta = 6.0 / 29.0
    f = np.where(t > delta ** 3, np.cbrt(t), t / (3 * delta ** 2) + 4.0 / 29)
    L = 116 * f[..., 1] - 16
    a = 500 * (f[..., 0] - f[..., 1])
    b = 200 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, b], axis=-1)


def prophoto_rgb_to_lab(img, linear=False):
    """(Gamma-encoded or linear) ProPhotoRGB -> Lab."""
    if not linear:
        img = linearize_prophoto_rgb(img)
    xyz = prophoto_rgb_to_xyz(img)
    xyz = xyz_chromatic_adapt(xyz, 'D50', 'D65')
    return _xyz_to_lab(xyz)


def get_image_center(image):
    """Largest centered square crop."""
    if image.shape[0] > image.shape[1]:
        start = (image.shape[0] - image.shape[1]) // 2
        image = image[start:start + image.shape[1], :]
    if image.shape[1] > image.shape[0]:
        start = (image.shape[1] - image.shape[0]) // 2
        image = image[:, start:start + image.shape[0]]
    return image


def make_image_grid(images, per_row=8, padding=2):
    """Tile a [N, H, W, C] batch into one image."""
    images = np.asarray(images)
    npad = ((0, 0), (padding, padding), (padding, padding), (0, 0))
    images = np.pad(images, pad_width=npad, mode='constant',
                    constant_values=1.0)
    assert images.shape[0] % per_row == 0
    num_rows = images.shape[0] // per_row
    rows = [np.hstack(images[i * per_row:(i + 1) * per_row])
            for i in range(num_rows)]
    return np.vstack(rows)
