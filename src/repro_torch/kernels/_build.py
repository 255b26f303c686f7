"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain ``extern "C"`` launcher, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Builds happen at first use, never at
import, into ``build/repro_torch_kernels/`` at the root of the checkout;
a library's file name carries a digest of its sources and flags, so an
edited source is rebuilt and an unchanged one is reused. ``nvcc`` runs with
``-Xptxas -v``; its report (registers, shared memory, spills per kernel)
is kept beside the library and returned by :func:`ptxas_report`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCES = ("bitserial_matmul", "bitserial_conv", "dynamic_quant",
           "flash_attention")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, else from ``PATH``, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"),
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names=SOURCES) -> float:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns the wall seconds
    spent; raises RuntimeError with the compiler's output if any fails."""
    import time
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", tmp,
               str(_CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        lib = library_path(name)
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines of a built library (registers, shared
    memory and spills per kernel)."""
    log = library_path(name).with_suffix(".log").read_text()
    return "\n".join(line for line in log.splitlines()
                     if "ptxas" in line or "spill" in line)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, compiled first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
