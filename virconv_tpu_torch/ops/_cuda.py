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
    """The loaded library of ``csrc/<name>.cu``, built on first use. Calls
    for different sources may run in parallel threads, one nvcc each."""
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
            lib = _libs[name] = ctypes.CDLL(str(out))
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
