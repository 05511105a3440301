"""Build and load a hand-written CUDA library at first use.

Every kernel package keeps its CUDA sources under ``csrc/`` and binds them
the same way: ``nvcc`` compiles them for ``sm_90a`` into a shared library
with a plain C interface (each source compiled to an object at once, in
parallel, then linked), and :mod:`ctypes` loads it — no PyTorch headers,
so a build takes seconds.  It happens at first use, from the package's own
sources, into ``build/`` at the root of the checkout.  The library's name
carries a hash of its sources, the headers they include and the flags, so
an edited file is rebuilt and a stale library is never loaded.  A missing
``nvcc`` or a failed build raises: there is no fallback.

Nothing here runs at import time — the CPU tests import every kernel module
on hosts without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# src/repro_torch/kernels/_build.py -> the checkout root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
            "/usr/local/cuda): the CUDA kernels cannot be built")
    return path


class CudaLibrary:
    """One shared library built from ``sources``, with C entry points.

    ``headers`` are the files the sources include: they are hashed into the
    library's name but not compiled on their own.  ``symbols`` maps each
    entry point to its ``ctypes`` argument types; every entry point returns
    ``cudaGetLastError()`` as an ``int``.
    """

    def __init__(self, name: str, sources, headers=(), symbols=None):
        self.name = name
        self.sources = tuple(Path(s) for s in sources)
        self.headers = tuple(Path(h) for h in headers)
        self.symbols = dict(symbols or {})
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        """Where the library for the current sources and flags lives."""
        h = hashlib.sha256()
        for f in self.sources + self.headers:
            h.update(f.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def build(self) -> tuple[Path, str]:
        """Compile the library if it is not built yet.

        Returns ``(path, log)``: ``log`` is the compiler's output (``-Xptxas
        -v`` prints each kernel's registers and shared memory), empty when
        the library was already built.  Raises ``RuntimeError`` with the
        compiler's output when the build fails.
        """
        out = self.path()
        if out.is_file():
            return out, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # one build across processes (the procs backend's workers load the
        # libraries too): the others wait here and find it built; the lock
        # dies with its holder, so a killed build blocks no later one
        with open(out.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if out.is_file():
                return out, ""
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                rc, log = self._compile(tmp)
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}) building "
                                       f"{out.name}:\n{log}")
                os.replace(tmp, out)    # atomic: readers never see a partial file
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return out, log

    def _compile(self, dst: str) -> tuple[int, str]:
        """Build the library into ``dst``: each source compiled to an object
        file at once, in parallel (one ``nvcc`` a translation unit: ptxas
        takes a file's kernels one after another), then linked.  Returns
        (exit code, compiler output)."""
        flags = [f for f in NVCC_FLAGS if f != "-shared"]
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objs:
            paths = [str(Path(objs) / f"{i}.o")
                     for i in range(len(self.sources))]
            with ThreadPoolExecutor(len(self.sources)) as pool:
                procs = list(pool.map(
                    lambda src, obj: subprocess.run(
                        [nvcc(), *flags, "-c", "-o", obj, str(src)],
                        capture_output=True, text=True),
                    self.sources, paths))
            log = "".join(p.stdout + p.stderr for p in procs)
            for p in procs:
                if p.returncode != 0:
                    return p.returncode, log
            link = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", dst, *paths],
                                  capture_output=True, text=True)
            return link.returncode, log + link.stdout + link.stderr

    def load(self) -> ctypes.CDLL:
        """The built library with every entry point's C signature declared."""
        with self._lock:
            if self._lib is None:
                path, _log = self.build()
                lib = ctypes.CDLL(str(path))
                for sym, argtypes in self.symbols.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def call(self, symbol: str, *args) -> None:
        """Call entry point ``symbol``; raises when the launch was refused."""
        err = getattr(self.load(), symbol)(*args)
        if err != 0:
            raise RuntimeError(f"{symbol}: kernel launch failed with CUDA "
                               f"error {err}")
