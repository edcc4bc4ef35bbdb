"""Build-and-load helper for the CUDA sources under ``csrc/``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` at first use and loaded with ``ctypes``.
The library's file name carries a hash of every source and header under
``csrc/`` and of the compiler flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing is compiled when this module is imported;
the first kernel launch (or :func:`build_all`) triggers the build.

The build directory is ``build/kernels/`` beside the package (override with
the environment variable ``ATM_TORCH_BUILD_DIR``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)  # no --use_fast_math: the kernels' FP32 arithmetic is IEEE

_libs: dict[str, ctypes.CDLL] = {}
last_build_seconds = 0.0


def build_dir() -> pathlib.Path:
    env = os.environ.get("ATM_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled at first use and need "
        "the CUDA toolkit (looked on PATH, $CUDA_HOME and /usr/local/cuda)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    return build_dir() / f"lib{name}_{source_hash()}.so"


def build_all(verbose: bool = False) -> dict[str, pathlib.Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet: one
    ``nvcc`` process per source, all started together. Returns the library
    path per kernel-source name. Raises with the compiler's output if a
    build fails."""
    global last_build_seconds
    t0 = time.perf_counter()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    paths = {}
    for src in sorted(CSRC.glob("*.cu")):
        name = src.stem
        so = library_path(name)
        paths[name] = so
        if so.exists():
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((name, so, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, so, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name} ({' '.join(cmd)}):\n{log}")
        os.replace(tmp, so)
        if verbose:
            print(log)
    last_build_seconds = time.perf_counter() - t0
    return paths


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the last build of ``name``; empty if it was not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        so = library_path(name)
        if not so.exists():
            build_all()
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
    return lib
