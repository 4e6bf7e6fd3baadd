"""Build and load the package's hand-written CUDA kernels.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) from the
sources in ``jammy_flows_tpu_torch/csrc/`` into ``build/cuda/`` beside the
package, at first use, and loaded with ``ctypes``.  The library name carries
a hash of its sources and flags, so an edited source is rebuilt.  Nothing
here runs at import time: this module imports on machines without a CUDA
toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "cuda"
# no fast-math: the block kernels' density and sample directions must
# evaluate identical libm expressions (expf/logf/log1pf) for the f32
# sample -> log_prob roundtrip to cancel
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources_hash(main, headers):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [main] + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name):
    """Path of the built shared library for csrc/<name>.cu."""
    main = CSRC / f"{name}.cu"
    headers = sorted(CSRC.glob("*.cuh"))
    return BUILD_DIR / f"lib{name}_{_sources_hash(main, headers)}.so"


def build(name, log=None):
    """Compile csrc/<name>.cu unless an up-to-date library exists; returns
    (path, compiled), compiled False when the library was already there.
    ``log`` (a callable) receives nvcc's -Xptxas -v report."""
    out = library_path(name)
    if out.exists():
        return out, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           str(CSRC / f"{name}.cu")]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
        if log is not None:
            log(res.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, True


def load(name, declare):
    """Build (if needed) and load csrc/<name>.cu once per process;
    ``declare(lib)`` sets argtypes/restype of every exported function."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[0]))
            declare(lib)
            _LOADED[name] = lib
        return lib
