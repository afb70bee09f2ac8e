"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` source is compiled by its own `nvcc` process, all
started together, for `sm_90a` (Hopper), then linked into one shared
library with a plain C interface, `_build/libmxtorch_kernels.so`, which
is loaded with ctypes. The build happens at first use (the first CUDA
call of a wrapper, or `chip_smoke.py`), never at import: a machine
without nvcc imports every module. A content stamp of the sources and
flags (headers included) skips the rebuild when nothing changed. `_build/build.log` keeps
nvcc's `-Xptxas -v` report (registers, shared memory, spills).
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["library", "build", "BUILD_DIR"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libmxtorch_kernels.so"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_lock = threading.Lock()
_lib = None

# While mx.inspect counts a step, [flops, bytes] that the kernel wrappers
# add each launch's matmul FLOPs and tensor bytes to (`tally`); None
# otherwise (one attribute check a launch). A dispatch mode sees ATen
# ops only, not these ctypes launches; on the CPU it sees the plain
# versions' own ops, which compute the same products.
cost_tally = None
# a callable given every launch's tensors while mx.check records a call
launch_observer = None


def tally(flops, *tensors):
    """Add one launch's FLOPs and the bytes of `tensors` (each read or
    written once) to `cost_tally`, and hand the tensors to
    `launch_observer` (mx.check's recorder: a ctypes launch's reads are
    invisible to a dispatch mode)."""
    t = cost_tally
    if t is not None:
        t[0] += flops
        t[1] += sum(x.numel() * x.element_size() for x in tensors
                    if x is not None)
    o = launch_observer
    if o is not None:
        o(tensors)


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def _digest(sources):
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources:
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + fh.read())
    return h.hexdigest()


def _fresh(out, stamp, digest):
    if os.path.exists(out) and os.path.exists(stamp):
        with open(stamp) as fh:
            return fh.read().strip() == digest
    return False


def build():
    """Compile the kernels if the sources changed; returns the path of
    the shared library. An exclusive lock on `_build/.lock` serialises
    processes that reach the first build together (two test workers, or
    chip_smoke.py beside a test run): the later one finds the library
    fresh and does not rebuild."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    out = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = out + ".sha256"
    digest = _digest(sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))))
    if _fresh(out, stamp, digest):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _fresh(out, stamp, digest):
            _compile(sources, out)
            with open(stamp, "w") as fh:
                fh.write(digest)
    return out


def _compile(sources, out):
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = os.path.join(BUILD_DIR, os.path.basename(src)[:-3] + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {os.path.basename(src)}\n{text}")
        if proc.returncode != 0:
            failed.append(src)
    tmp = out + ".tmp"
    if not failed:
        link = subprocess.run(
            [nvcc, *FLAGS[:2], "-shared", "-o", tmp]
            + [obj for _, obj, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as fh:
        fh.write("\n".join(log))
    if failed:
        raise RuntimeError(f"kernel build failed ({failed}):\n"
                           + "\n".join(log))
    os.replace(tmp, out)


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
        return _lib


def check(err, what):
    """Raise when a C entry returned a CUDA error code."""
    if err != 0:
        lib = library()
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
        lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.mx_cuda_error_string(int(err)).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
