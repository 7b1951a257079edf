"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` into a shared library of its
own with a plain C interface (no PyTorch headers, so each file builds in
seconds), all files in parallel, at the first kernel launch of a process.
Libraries land in `_build/<hash>/`, where the hash covers every source file
and the compiler flags: an edited kernel rebuilds, an unchanged one loads
at once. The libraries are bound with `ctypes`: tensors pass as
`data_ptr()` pointers, the stream as `torch.cuda.current_stream()`'s
handle, and every C entry point returns `cudaGetLastError()` after its
launches, which `Kernel.__call__` turns into an exception.

Nothing here runs at import time, so the CPU-only test environment imports
every module without a CUDA toolkit.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(_HERE, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Optional[float] = None    # wall time of this process's build


def _sources() -> List[str]:
    return sorted(f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources():
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_dir() -> str:
    """Directory holding the compiled libraries, building them if needed.
    All `.cu` files compile concurrently, one nvcc process each."""
    global build_seconds
    out = os.path.join(BUILD_ROOT, _source_hash())
    if os.path.isdir(out):
        return out
    t0 = time.perf_counter()
    os.makedirs(BUILD_ROOT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT)
    nvcc = _nvcc()
    procs = []
    try:
        for src in (s for s in _sources() if s.endswith(".cu")):
            name = src[:-3]
            log = open(os.path.join(tmp, f"{name}.log"), "w")
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC,
                   "-o", os.path.join(tmp, f"lib{name}.so"),
                   os.path.join(CSRC, src)]
            procs.append((name, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for name, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(name)
        if failed:
            msgs = []
            for name in failed:
                with open(os.path.join(tmp, f"{name}.log")) as f:
                    msgs.append(f"--- {name}.cu ---\n{f.read()[-4000:]}")
            raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
        try:
            os.rename(tmp, out)
        except OSError:
            if not os.path.isdir(out):     # lost a race to another process
                raise
    finally:
        for _, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`'s library."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(os.path.join(build_dir(), f"lib{name}.so"))
            lib.ivfadc_error_string.argtypes = [ctypes.c_int]
            lib.ivfadc_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


class HostFn:
    """One C entry point of a kernel library that launches nothing (a
    launch plan, say); a nonzero return raises."""

    def __init__(self, lib: str, fn: str, argtypes):
        self.lib = lib
        self.fn = fn
        self.argtypes = list(argtypes)
        self._cfn = None

    def __call__(self, *args) -> None:
        if self._cfn is None:
            lib = load(self.lib)
            cfn = getattr(lib, self.fn)
            cfn.argtypes = self.argtypes
            cfn.restype = ctypes.c_int
            self._cfn = (lib, cfn)
        lib, cfn = self._cfn
        err = cfn(*args)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.fn} failed: "
                f"{lib.ivfadc_error_string(err).decode()} (error {err})")


_capturing = threading.local()      # .log: the kernels a capture launched


class Kernel(HostFn):
    """One C entry point of a kernel library plus its launch count.

    `launches` grows by one for every successful call, and is the only
    place a kernel's use is counted: a run can show that its path went
    through the kernel by zeroing the count before and reading it after.
    A call inside `capturing()` is logged instead, and each replay of the
    captured graph counts its launches (`credit`).
    """

    def __init__(self, lib: str, fn: str, argtypes):
        super().__init__(lib, fn, argtypes)
        self.launches = 0

    def __call__(self, *args) -> None:
        super().__call__(*args)
        log = getattr(_capturing, "log", None)
        if log is None:
            self.launches += 1
        else:
            log.append(self)


@contextlib.contextmanager
def capturing():
    """Log, instead of counting, the kernels this thread launches inside
    the block (a CUDA graph's capture); yields the log."""
    log: List[Kernel] = []
    _capturing.log = log
    try:
        yield log
    finally:
        _capturing.log = None


def credit(kernels: List[Kernel]) -> None:
    """Count one launch of each kernel a replayed graph holds."""
    for kern in kernels:
        kern.launches += 1


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
