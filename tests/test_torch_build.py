"""The shared kernel build helper (``repro_torch.kernels._build``) without
``nvcc``: the commands it runs, with ``subprocess.run`` standing in.

Every library, of one source or several, compiles each source to an
object file at once, in parallel, and then links the objects (the chain
library: ``chain.cu`` beside the translation units of ``chain_attn``'s
tensor-core kernels).
"""

import re
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels.chain import kernel as chain_kernel


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    """Every command run, with the threads that ran them; each writes its
    ``-o`` file and prints the source it compiled; a compile (``-c``) waits
    at ``compiles``, a barrier the test sets for its number of sources."""
    calls = []
    lock = threading.Lock()
    compiles = {}

    def run(cmd, capture_output, text):
        if "-c" in cmd:
            compiles["barrier"].wait()
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        with lock:
            calls.append((cmd, threading.get_ident()))
        return SimpleNamespace(returncode=0, stdout=f"ran {cmd[-1]}\n",
                               stderr="")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", run)
    return calls, compiles


def _sources(tmp_path, names):
    out = []
    for name in names:
        path = tmp_path / name
        path.write_text(f"// {name}\n")
        out.append(path)
    return out


@pytest.mark.parametrize("n", [1, 3])
def test_every_library_compiles_apart_then_links(fake_nvcc, tmp_path, n):
    calls, compiles = fake_nvcc
    # the compiles pass this barrier only when all n run at once
    compiles["barrier"] = threading.Barrier(n, timeout=30)
    srcs = _sources(tmp_path, ["a.cu", "b.cu", "c.cu"][:n])
    path, log = _build.CudaLibrary("lib", srcs).build()
    assert path.is_file()
    compiles = [cmd for cmd, _t in calls if "-c" in cmd]
    links = [cmd for cmd, _t in calls if "-c" not in cmd]
    # each source once, as an object, without -shared; then one link of
    # every object, with the library's flags
    assert sorted(cmd[-1] for cmd in compiles) == sorted(map(str, srcs))
    assert all("-shared" not in cmd for cmd in compiles)
    objects = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    (link,) = links
    assert link[:1 + len(_build.NVCC_FLAGS)] == ["nvcc", *_build.NVCC_FLAGS]
    assert sorted(link[link.index("-o") + 2:]) == sorted(objects)
    assert calls[-1][0] is link
    # each compiler's output in the log (chip_smoke.py reads its -Xptxas -v
    # lines); the compiles ran at once, on threads of their own
    assert all(f"ran {s}" in log for s in srcs)
    assert len({t for cmd, t in calls if "-c" in cmd}) == len(srcs)


def test_a_failed_compile_raises_with_its_output(monkeypatch, tmp_path):
    def run(cmd, capture_output, text):
        bad = cmd[-1].endswith("b.cu")
        if not bad:
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return SimpleNamespace(returncode=2 if bad else 0, stdout="",
                               stderr="error in b\n" if bad else "")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", run)
    lib = _build.CudaLibrary("bad", _sources(tmp_path, ["a.cu", "b.cu"]))
    with pytest.raises(RuntimeError, match="error in b"):
        lib.build()
    assert not lib.path().exists()


def test_chain_attn_instantiations_are_declared_extern_in_chain_cu():
    """The chain library is chain.cu (its extern "C" entry points first)
    and the translation units of chain_attn's tensor-core kernels: every
    instantiation they define, chain.cu declares extern (so it compiles
    none of those kernels itself), and each is defined once."""
    first, *units = chain_kernel.SOURCES
    assert first.name == "chain.cu" and units
    pattern = r"template cudaError_t bind_chain_tc::launch<([\w:]+)>\("
    declared = re.findall(r"extern " + pattern, first.read_text())
    defined = [t for u in units for t in re.findall(
        r"^" + pattern, u.read_text(), re.M)]
    assert sorted(declared) == sorted(defined) == sorted(
        ["float", "__nv_bfloat16", "__half"])
    for unit in units:
        assert '#include "chain_attn_tc.cuh"' in unit.read_text()
        assert 'extern "C"' not in unit.read_text()
