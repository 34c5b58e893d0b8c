"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``virconv_tpu_torch/_build/``
(listed in ``.gitignore``) at first use, then loaded with ``ctypes``. No
PyTorch headers are included, so a build takes seconds. A library's name
carries a digest of its source, of every ``csrc`` header the source
includes and of the flags, so an edit to any of them builds anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD = _PKG / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '--fmad=false']
SOURCES = ('band_conv', 'roi_pool', 'gather_conv', 'gather_rows', 'cspn')

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_LL, _F = ctypes.c_longlong, ctypes.c_float
# Every C entry point of each library, (restype, argtypes), set once when
# the library is loaded. Pointers and the stream are c_void_p: ctypes would
# pass a Python int as a 32-bit int and cut it.
SIGNATURES = {
    'band_conv': {
        'band_conv_fwd_scratch_bytes': (_L, [_I] * 5),
        'band_conv_fwd': (_I, [_P] * 6 + [_I] * 5 + [_P] * 3 + [_I] * 7
                          + [_P] * 3 + [_I] * 3 + [_P] * 3),
        'band_conv_dw_scratch_bytes': (_L, [_I] * 6),
        'band_conv_dw': (_I, [_P] * 6 + [_I] * 5 + [_P] + [_I] * 6
                         + [_P] * 3),
        'nmap_conv_dw_scratch_bytes': (_L, [_I] * 5),
        'nmap_conv_dw': (_I, [_P] * 3 + [_I] * 6 + [_P] * 3)},
    'roi_pool': {
        'roi_pool_fwd': (_I, [_P] * 9 + [_I] * 7 + [_F] * 6
                         + [_P, _P, _I, _P])},
    'gather_conv': {
        'gather_conv_scratch_bytes': (_L, [_I] * 4),
        'gather_conv_fwd': (_I, [_P] * 3 + [_I] * 6 + [_P] * 4),
        'nmap_conv_fwd': (_I, [_P] * 3 + [_I] * 6 + [_P] * 4),
        'nmap_conv_fwd_prev': (_I, [_P] * 3 + [_I] * 6 + [_P] * 4),
        'onehot_window_blocks': (_I, [_P] + [_I] * 4 + [_P] * 3),
        'onehot_conv_scratch_bytes': (_L, [_I] * 5),
        'onehot_conv_fwd': (_I, [_P] * 4 + [_I] * 8 + [_P] * 4)},
    'gather_rows': {
        'gather_rows_fwd': (_I, [_P] * 3 + [_LL, _I, _P, _P]),
        'gather_rows_csr_scratch_bytes': (_LL, [_LL, _LL]),
        'gather_rows_csr': (_I, [_P, _P, _LL, _LL, _P, _P]),
        'gather_rows_sum': (_I, [_P, _P, _LL, _LL, _I, _P, _P])},
    'cspn': {
        'cspn_iteration': (_I, [_P] * 9 + [_I] * 5 + [_P] * 4)},
}

_libs = {}
_locks = {name: threading.Lock() for name in SOURCES}


def _nvcc():
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = Path(home) / 'bin' / 'nvcc'
    return str(cand) if cand.exists() else 'nvcc'


def _sources(src):
    """``src`` and every local header it includes, transitively."""
    seen, todo = set(), [src]
    while todo:
        path = todo.pop()
        if path not in seen:
            seen.add(path)
            todo += [path.parent / inc
                     for inc in _INCLUDE.findall(path.read_text())]
    return sorted(seen)


def _target(name):
    src = CSRC / f'{name}.cu'
    h = hashlib.sha1(' '.join(NVCC_FLAGS).encode())
    for path in _sources(src):
        h.update(path.name.encode() + b'\0' + path.read_bytes())
    return src, BUILD / f'lib{name}_{h.hexdigest()[:12]}.so'


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, its
    entry points' signatures set (``SIGNATURES``). Calls for different
    sources may run in parallel threads, one nvcc each."""
    with _locks[name]:
        lib = _libs.get(name)
        if lib is None:
            src, out = _target(name)
            if not out.exists():
                BUILD.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f'.{os.getpid()}.tmp')
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f'nvcc failed for {out.name}:\n'
                                       f'{proc.stdout}{proc.stderr}')
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_cuda_tensor(t, name, dtype, ndim=None, device=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``."""
    if not t.is_cuda:
        raise ValueError(f'{name}: expected a CUDA tensor')
    if device is not None and t.device != device:
        raise ValueError(f'{name}: on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise ValueError(f'{name}: dtype {t.dtype}, expected {dtype}')
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f'{name}: {t.ndim} dims, expected {ndim}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: must be contiguous')
