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


def build_all(names, log=None):
    """Compile each csrc/<name>.cu that has no up-to-date library, all nvcc
    processes started together; returns {name: (path, compiled)}, compiled
    False when the library was already there.  ``log`` (a callable)
    receives each nvcc's -Xptxas -v report."""
    result, running = {}, []
    for name in names:
        out = library_path(name)
        if out.exists():
            result[name] = (out, False)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        running.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    try:
        for name, out, tmp, proc in running:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n{err}")
                continue
            if log is not None:
                log(err)
            os.replace(tmp, out)
            result[name] = (out, True)
    finally:
        for _, _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return result


def load(name, declare):
    """Build (if needed) and load csrc/<name>.cu once per process;
    ``declare(lib)`` sets argtypes/restype of every exported function."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name][0]))
            declare(lib)
            _LOADED[name] = lib
        return lib


def time_builds():
    """Seconds of a cold build of every csrc/*.cu, one nvcc after another
    and all started together, each into a fresh directory under build/:

        python -m jammy_flows_tpu_torch.ops.cuda_build
    """
    import time
    global BUILD_DIR
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    root = BUILD_DIR
    for how in ("sequential", "parallel"):
        BUILD_DIR = root.parent / f"cuda_time_{how}"
        shutil.rmtree(BUILD_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        if how == "parallel":
            build_all(names)
        else:
            for name in names:
                build_all([name])
        print(f"{how} build of {', '.join(names)}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        shutil.rmtree(BUILD_DIR)
    BUILD_DIR = root


if __name__ == "__main__":
    time_builds()
