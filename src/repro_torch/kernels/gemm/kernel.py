"""Build and bind the hand-written Hopper GEMM (``csrc/gemm.cu``).

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with :mod:`ctypes` — no PyTorch
headers, so the build takes seconds.  It happens at first use, from the
package's own sources, into ``build/`` at the root of the checkout; the
library's name carries a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded.  A missing ``nvcc`` or a
failed build raises: there is no fallback.

Nothing here runs at import time — the CPU tests import this module on
hosts without ``nvcc`` or a GPU.
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

import torch

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "gemm.cu",)
# src/repro_torch/kernels/gemm/kernel.py -> the checkout root
BUILD_DIR = _HERE.parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# torch dtype -> C entry point of csrc/gemm.cu
SYMBOLS = {
    torch.float32: "bind_gemm_f32",
    torch.bfloat16: "bind_gemm_bf16",
    torch.float64: "bind_gemm_f64",
}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.is_file():
            path = str(cand)
    if path is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME or "
            "/usr/local/cuda): the GEMM kernel cannot be built")
    return path


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbind_gemm_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet.

    Returns ``(path, log)``: ``log`` is the compiler's output (``-Xptxas
    -v`` prints each kernel's registers and shared memory), empty when the
    library was already built.  Raises ``RuntimeError`` with the compiler's
    output when the build fails.
    """
    out = library_path()
    if out.is_file():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)],
            capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {out.name}:\n{log}")
        os.replace(tmp, out)        # atomic: readers never see a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, log


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared."""
    path, _log = build()
    lib = ctypes.CDLL(str(path))
    for name in SYMBOLS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def launch(a: torch.Tensor, b: torch.Tensor, c, out: torch.Tensor) -> None:
    """Enqueue ``out = a @ b (+ c)`` on the current stream of ``a``'s device.

    The caller (:mod:`.ops`) has checked devices, dtypes, shapes and
    contiguity and allocated ``out``.  Does not synchronise; raises when the
    launch is refused (the C function returns ``cudaGetLastError()``).
    """
    fn = getattr(load(), SYMBOLS[a.dtype])
    m, k = a.shape
    n = b.shape[1]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(),
                 c.data_ptr() if c is not None else None, out.data_ptr(),
                 m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"GEMM kernel launch failed: CUDA error {err} "
                           f"(m={m}, n={n}, k={k}, dtype={a.dtype})")
