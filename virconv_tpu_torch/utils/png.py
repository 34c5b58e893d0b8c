"""PNG reading and writing without an image library.

``read_png`` decodes what KITTI ships: 8-bit RGB, not interlaced. It
returns (H, W, 3) uint8 in RGB order (``cv2.imread(path)[..., ::-1]``) and
raises on any other kind of PNG. The rows are inflated with ``zlib``; the
five row filters are undone by ``csrc/png.cpp`` (built by ``g++`` at first
use through ``ops/native.build('png')``), since Average and Paeth are
sequential along a row. ``encode_png`` writes such a file with a chosen
filter per row (the filters of an encoder only read the raw image, so
they vectorise in numpy).
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
FILTERS = ('none', 'sub', 'up', 'average', 'paeth')

_LIB = None
_LOCK = threading.Lock()


def _unfilter_lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            from ..ops import native
            lib = ctypes.CDLL(str(native.build('png')))
            u8p = np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')
            lib.png_unfilter.argtypes = [u8p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int, u8p]
            lib.png_unfilter.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _chunks(data):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, tag = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            break
        yield tag, body
        pos += 12 + n
        if tag == b'IEND':
            return
    raise ValueError('truncated PNG')


def read_png(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an 8-bit RGB, non-interlaced PNG."""
    data = Path(path).read_bytes()
    if data[:8] != SIGNATURE:
        raise ValueError(f'{path}: not a PNG')
    header, idat = None, []
    for tag, body in _chunks(data):
        if tag == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif tag == b'IDAT':
            idat.append(body)
    if header is None:
        raise ValueError(f'{path}: no IHDR chunk')
    w, h, depth, color, comp, filt, interlace = header
    if (depth, color, comp, filt, interlace) != (8, 2, 0, 0, 0):
        raise ValueError(
            f'{path}: bit depth {depth}, colour type {color}, interlace '
            f'{interlace}: only 8-bit RGB without interlace is read')
    stride = 3 * w
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f'{path}: {raw.size} bytes of rows, expected '
                         f'{h * (stride + 1)}')
    out = np.empty((h, w, 3), np.uint8)
    bad = _unfilter_lib().png_unfilter(raw, h, stride, 3, out)
    if bad:
        raise ValueError(f'{path}: row {bad - 1} has an unknown filter '
                         f'type {raw[(bad - 1) * (stride + 1)]}')
    return out


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(image, filters=('none',)) -> bytes:
    """An 8-bit RGB PNG of ``image`` (H, W, 3) uint8, row y filtered with
    ``filters[y % len(filters)]`` (names of ``FILTERS``)."""
    img = np.ascontiguousarray(image, np.uint8)
    h, w, _ = img.shape
    cur = img.reshape(h, 3 * w).astype(np.int32)
    up = np.vstack([np.zeros((1, 3 * w), np.int32), cur[:-1]])
    left = np.hstack([np.zeros((h, 3), np.int32), cur[:, :-3]])
    upleft = np.hstack([np.zeros((h, 3), np.int32), up[:, :-3]])
    pred = {'none': 0, 'sub': left, 'up': up, 'average': (left + up) >> 1,
            'paeth': _paeth(left, up, upleft)}
    rows = np.empty((h, 3 * w + 1), np.uint8)
    for y in range(h):
        name = filters[y % len(filters)]
        p = pred[name]
        rows[y, 0] = FILTERS.index(name)
        rows[y, 1:] = (cur[y] - (p if np.isscalar(p) else p[y])) % 256

    def chunk(tag, data):
        return (struct.pack('>I', len(data)) + tag + data
                + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))
    return (SIGNATURE
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
            + chunk(b'IEND', b''))
