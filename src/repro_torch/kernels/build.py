"""Build and load the hand-written CUDA kernels of the port.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``; the
device code the kernels share lives in ``csrc/*.cuh``. A build takes
seconds (no PyTorch headers). Libraries land in ``build/repro_torch/`` at
the repository root, named by a hash of the source, every shared header,
the flags and the compiler's version, so an edited source or header, or
another toolkit, is rebuilt on first use and an unchanged one is reused.
Inside ``with sources(path):`` every kernel is built and loaded from
another copy of ``csrc/`` instead (a variant of the device code, timed
through the same wrappers as the port's own).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["KERNELS", "NVCC_FLAGS", "build", "load", "function", "build_dir",
           "sources"]

KERNELS = ("stepped_trsm", "stepped_syrk", "stepped_trsm_syrk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CSRC = Path(__file__).resolve().with_name("csrc")

_LIBS: dict = {}  # (source directory, name): loaded library
_LOCK = threading.Lock()
_SOURCES = [CSRC]  # the source directory in use: the last entry


def build_dir() -> Path:
    """``<repo>/build/repro_torch`` (listed in .gitignore)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return nvcc


@functools.lru_cache(maxsize=1)
def _nvcc_version() -> bytes:
    return subprocess.run([_nvcc(), "--version"], capture_output=True,
                          check=True, timeout=60).stdout


@contextlib.contextmanager
def sources(csrc):
    """Build, load and launch every kernel from the directory ``csrc`` (a
    copy of ``csrc/``, device code edited) inside the block."""
    _SOURCES.append(Path(csrc).resolve())
    try:
        yield
    finally:
        _SOURCES.pop()


def _library_path(name: str, csrc=None) -> Path:
    csrc = Path(csrc) if csrc is not None else _SOURCES[-1]
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(_nvcc_version())
    digest = h.hexdigest()
    return build_dir() / f"{name}-{digest[:16]}.so"


def build(names=KERNELS, csrc=None) -> dict:
    """Compile every named kernel that is not built yet (from ``csrc``, by
    default the sources in use), all ``nvcc`` processes started together.
    Returns {name: seconds} of the builds run; ``-Xptxas -v`` output
    (registers, spills) goes to ``<library>.log``. Raises ``RuntimeError``
    with the compiler's output if one fails."""
    csrc = Path(csrc) if csrc is not None else _SOURCES[-1]
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _library_path(name, csrc)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT), tmp, out)
    seconds = {}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode:
            failed.append(f"nvcc failed for {name}:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    csrc = _SOURCES[-1]
    with _LOCK:
        lib = _LIBS.get((csrc, name))
        if lib is None:
            build([name], csrc)
            lib = ctypes.CDLL(str(_library_path(name, csrc)))
            _LIBS[csrc, name] = lib
        return lib


def function(name: str, symbol: str, n_ptr: int, n_int: int):
    """The C function ``symbol`` of kernel library ``name``, typed as every
    launcher of the port is: ``n_ptr`` pointers, ``n_int`` ints, then the
    stream; returns an int CUDA error code."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
