"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<digest>.so`` under the repository root (the
digest covers the source and the flags, so an edited source never loads a
stale library). Building happens at first use, never at import: the module
imports on machines without a CUDA toolkit, where only the plain PyTorch
versions run. ``build()`` starts one nvcc per source at once, so a cold
process pays for the slowest source, not the sum.
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
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("histogram", "split_pair")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found; the CUDA kernels build from csrc/ with the CUDA "
            "toolkit (set CUDA_HOME)"
        )
    return found


def library_path(name: str) -> Path:
    src = CSRC / ("%s.cu" % name)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / ("lib%s-%s.so" % (name, digest))


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that has no library yet, all at once.

    Returns the seconds each compile took (0.0 for one already built); the
    ptxas report (registers, shared memory, spills) lands beside each
    library as ``.log``. Raises with nvcc's output when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    secs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / ("%s.cu" % name))]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[name] = (proc, tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in started.items():
        log_text, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log_text)
        if proc.returncode != 0:
            errors.append("nvcc failed for %s.cu:\n%s" % (name, log_text))
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def check(code: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if code != 0:
        raise RuntimeError("%s failed: CUDA error %d" % (what, code))
