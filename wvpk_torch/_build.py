"""Build the CUDA sources in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exports a plain C function (no PyTorch headers, so
nvcc takes seconds, not minutes). It compiles on first use into
`build/wvpk_torch/<name>-<hash>.so` at the root of the checkout; the hash
covers the source and the flags, so an edited source rebuilds. The
finished library is renamed into place, so concurrent first uses never
load a half-written file.
"""

from __future__ import annotations

import ctypes
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = os.path.join(_CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    so_path = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.tmp{os.getpid()}"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, so_path)
        build_seconds[name] = time.perf_counter() - t0
        ptxas_log[name] = proc.stderr
    lib = ctypes.CDLL(so_path)
    _libs[name] = lib
    return lib
