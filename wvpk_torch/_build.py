"""Build the CUDA sources in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exports a plain C function (no PyTorch headers, so
nvcc takes seconds, not minutes); the `.cuh` headers beside them are
shared. A source compiles on first use into
`build/wvpk_torch/<name>-<hash>.so` at the root of the checkout; the hash
covers the source, the headers and the flags, so an edit rebuilds. The
finished library is renamed into place, so concurrent first uses never
load a half-written file. `build_all` starts one nvcc per source, all at
once, and waits for them.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "wvpk_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("entropy", "decorr", "wvc", "wvx", "dsd_fast", "dsd_high",
           "encode_invert", "encode_words", "encode_hybrid")

_libs: dict[str, ctypes.CDLL] = {}
# seconds nvcc took and what ptxas reported (registers, spills), per
# source built by this process; a source found already built is absent
build_seconds: dict[str, float] = {}
ptxas_log: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return path


def _so_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(_CSRC, name + ".cu"),
                 *sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names=SOURCES) -> None:
    """Build every named source that is not built yet, one nvcc process
    each, all started together; raises if any fails."""
    todo = [(n, _so_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not os.path.exists(p)]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, so_path in todo:
        tmp = f"{so_path}.tmp{os.getpid()}"
        src = os.path.join(_CSRC, name + ".cu")
        procs.append((name, so_path, tmp, src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, so_path, tmp, src, proc in procs:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{err}")
            continue
        os.replace(tmp, so_path)
        build_seconds[name] = time.perf_counter() - t0
        ptxas_log[name] = err
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(_so_path(name))
    _libs[name] = lib
    return lib
