"""Build and load the hand-written CUDA kernels of the port.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``. A build
takes seconds (no PyTorch headers). Libraries land in ``build/repro_torch/``
at the repository root, named by a hash of the source and the flags, so an
edited source is rebuilt on first use and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["KERNELS", "NVCC_FLAGS", "build", "load", "build_dir"]

KERNELS = ("stepped_trsm", "stepped_syrk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CSRC = Path(__file__).resolve().with_name("csrc")

_LIBS: dict = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    """``<repo>/build/repro_torch`` (listed in .gitignore)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return nvcc


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{name}-{digest[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes started together. Returns {name: seconds} of the builds run;
    ``-Xptxas -v`` output (registers, spills) goes to ``<library>.log``.
    Raises ``RuntimeError`` with the compiler's output if one fails."""
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            _LIBS[name] = lib
        return lib
