"""Shared-memory payload arenas for the process-pool backend.

One worker process per simulated rank keeps its rank-local store in
``multiprocessing.shared_memory`` segments, one segment per *(version,
rank)* replica.  Segment names are a pure function of ``(session, version
key, rank)``, so any process can attach a replica by name with zero
coordination — the wavefront barrier (not a message) is what guarantees a
producer's segment exists before a consumer attaches.  A ship is one
``memcpy`` from the source rank's segment into a fresh segment owned by the
destination rank, so replica ownership (and therefore GC/unlink
responsibility) is always single-rank.  The frontend seeds a worker with a
payload the same way: it writes the segment under the worker's name, and
the worker adopts it (:meth:`WorkerArena.adopt`) — payloads never travel
through the control pipe.

Segments are self-describing: a small header carries the payload kind
(pickled object / NumPy array / tensor), dtype and shape, and for a tensor
its device, so the frontend can rehydrate a payload it never saw — plans
are shape-oblivious and op results are born inside workers.  The payload
bytes start at a 64-byte boundary of the segment.

* **NumPy** payloads stay NumPy: rank-local reads are zero-copy read-only
  views of the mapped buffer, as in the reference.
* **Tensors** (``KIND_TORCH``, the reference's ``KIND_JAX``) are stored as
  their raw bytes — bfloat16 as its bits, nothing is promoted — with the
  device they lay on.  A CPU tensor comes back as a CPU tensor, a zero-copy
  view of the segment.  A CUDA tensor is staged through host memory: one
  device-to-host copy into the segment when it is stored, one
  host-to-device copy onto the same device index each time it is read,
  and never silently a CPU tensor — reading one in a process without CUDA
  raises.
* Anything else is pickled.
"""

from __future__ import annotations

import os
import pickle
import struct
import time
from multiprocessing import shared_memory
from typing import Any, Optional

import numpy as np
import torch

KIND_PICKLE = 0     # arbitrary python object, pickled
KIND_NUMPY = 1      # np.ndarray, raw bytes
KIND_TORCH = 2      # torch.Tensor, raw bytes + device, rehydrated on read

# what this process has staged between a card and the segments: the bytes
# of CUDA tensors copied in (``to_host``) and read back onto their device
# (``to_device``), and the host seconds those copies took (a copy to the
# host waits for the kernels queued before it); observability only
STAGED = {"to_host": 0, "to_device": 0, "seconds": 0.0}

# kind, dtype-name length, device type, device index, pad, ndim
_HEADER = struct.Struct("<BBBh3xB")
_ALIGN = 64
_DEVICE_TYPES = ("cpu", "cuda")
# The port's segments carry a prefix of their own.  The reference package
# names its segments ``bnd{session}-...`` with the same ``pid-seq`` sessions
# (its own counter, also from 1), so under one prefix a reference pool alive
# in the same process could hold segments that match a port pool's names;
# ``t`` is no hex digit, so no reference name starts with this prefix.
SEGMENT_PREFIX = "bndt"


def segment_name(session: str, vkey: tuple[int, int], rank: int) -> str:
    """Deterministic shm name for one (version, rank) replica."""
    return f"{SEGMENT_PREFIX}{session}-{vkey[0]}-{vkey[1]}-r{rank}"


def payload_kind(payload: Any) -> int:
    if type(payload) is np.ndarray:
        # object and structured arrays hold more than their raw bytes say
        return (KIND_PICKLE if payload.dtype.hasobject
                or payload.dtype.fields is not None else KIND_NUMPY)
    if (isinstance(payload, torch.Tensor) and payload.layout == torch.strided
            and payload.device.type in _DEVICE_TYPES):
        return KIND_TORCH
    return KIND_PICKLE


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _encode(payload: Any) -> tuple[int, bytes, Any]:
    """``(kind, header bytes, data)`` for one payload: ``data`` is None for
    a pickled object (its bytes are in the header), a contiguous ndarray,
    or a contiguous tensor (on its own device)."""
    kind = payload_kind(payload)
    if kind == KIND_PICKLE:
        raw = pickle.dumps(payload)
        header = (_HEADER.pack(kind, 0, 0, 0, 0) + struct.pack("<Q", len(raw))
                  + raw)
        return kind, header, None
    if kind == KIND_NUMPY:
        data = payload if payload.flags.c_contiguous else \
            np.ascontiguousarray(payload)
        dname = data.dtype.str.encode()
        dev_type = dev_index = 0
        nbytes = data.nbytes
    else:
        data = payload.detach().resolve_conj().resolve_neg().contiguous()
        dname = str(data.dtype).removeprefix("torch.").encode()
        dev_type = _DEVICE_TYPES.index(data.device.type)
        dev_index = data.device.index if data.device.index is not None else -1
        nbytes = data.numel() * data.element_size()
    header = (_HEADER.pack(kind, len(dname), dev_type, dev_index, data.ndim)
              + dname + struct.pack(f"<{data.ndim}q", *data.shape)
              + struct.pack("<Q", nbytes))
    return kind, header, data


def _layout(buf) -> tuple:
    """``(kind, dtype name, device, shape, nbytes, data offset)`` of an
    array segment."""
    kind, dlen, dev_type, dev_index, ndim = _HEADER.unpack_from(buf, 0)
    off = _HEADER.size
    dname = bytes(buf[off:off + dlen]).decode()
    off += dlen
    shape = struct.unpack_from(f"<{ndim}q", buf, off)
    off += 8 * ndim
    (nbytes,) = struct.unpack_from("<Q", buf, off)
    off += 8
    device = (_DEVICE_TYPES[dev_type], dev_index)
    return kind, dname, device, shape, nbytes, _aligned(off)


def _unpickle(buf):
    (n,) = struct.unpack_from("<Q", buf, _HEADER.size)
    start = _HEADER.size + 8
    return pickle.loads(bytes(buf[start:start + n]))


def _host_tensor(buf, dname: str, shape, nbytes: int, off: int
                 ) -> torch.Tensor:
    """A CPU tensor viewing the segment's bytes (no copy).  Made through
    NumPy, whose array holds the buffer export, so the mapping cannot be
    closed under the tensor (``torch.frombuffer`` keeps only a reference
    to the buffer object, and a closed mmap would leave it dangling)."""
    dtype = getattr(torch, dname)
    if nbytes == 0:
        return torch.empty(shape, dtype=dtype)
    raw = np.frombuffer(buf, dtype=np.uint8, count=nbytes, offset=off)
    return torch.from_numpy(raw).view(dtype).view(shape)


def _on_device(host: torch.Tensor, device: tuple) -> torch.Tensor:
    """``host`` on the device it was stored from: CPU as it is, CUDA as a
    copy onto the same device index (raises where there is no CUDA)."""
    dev_type, dev_index = device
    if dev_type == "cpu":
        return host
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"a shared-memory payload holds a tensor of cuda:{dev_index}, "
            f"but CUDA is not available in process {os.getpid()}")
    t0 = time.perf_counter()
    out = host.to(torch.device(dev_type, dev_index))
    STAGED["seconds"] += time.perf_counter() - t0
    STAGED["to_device"] += host.numel() * host.element_size()
    return out


def _read(buf, copy: bool) -> tuple[int, Any]:
    """``(kind, payload)`` of a segment: NumPy and CPU tensors as views of
    ``buf`` unless ``copy``; a CUDA tensor always a copy on its device."""
    kind = buf[0]
    if kind == KIND_PICKLE:
        return kind, _unpickle(buf)
    kind, dname, device, shape, nbytes, off = _layout(buf)
    if kind == KIND_NUMPY:
        dtype = np.dtype(dname)
        arr = np.frombuffer(buf, dtype=dtype, count=nbytes // dtype.itemsize,
                            offset=off).reshape(shape)
        if copy:
            return kind, arr.copy()
        arr.flags.writeable = False
        return kind, arr
    host = _host_tensor(buf, dname, shape, nbytes, off)
    if copy and device[0] == "cpu":
        host = host.clone()
    return kind, _on_device(host, device)


def _attach(name: str) -> shared_memory.SharedMemory:
    """Attach an existing segment *as a reader*.

    CPython ≤3.12 registers every attach with the resource tracker, but
    frontend and workers share one tracker daemon (spawned children inherit
    its fd), so the re-registration is an idempotent set-add and the
    owner's eventual unlink clears the single shared entry.
    """
    return shared_memory.SharedMemory(name=name)


def read_segment(name: str) -> tuple[int, Any]:
    """Attach ``name``, decode a copy of its payload, detach."""
    seg = _attach(name)
    try:
        return _read(seg.buf, copy=True)
    finally:
        _close_quiet(seg)


def peek_nbytes(name: str) -> int:
    """Accounting nbytes of a segment's payload without copying it out.

    Mirrors ``stats._nbytes``: array payloads report their raw byte count,
    pickled objects report 0.  Used by the frontend to reconstruct the
    commit sizes of a SIGKILL'd worker whose "done" message never arrived —
    the segments survive the process.
    """
    seg = _attach(name)
    try:
        if seg.buf[0] == KIND_PICKLE:
            return 0
        return int(_layout(seg.buf)[4])
    finally:
        _close_quiet(seg)


def _close_quiet(seg: shared_memory.SharedMemory) -> None:
    """Close a segment tolerating live exports.

    An op body or a fetched payload may still reference a zero-copy view
    of the segment's mmap, which makes ``mmap.close()`` raise
    ``BufferError``.  The *unlink* is what frees the name and (once all
    maps die) the memory; a stale private mapping is reclaimed when its
    last view dies, so a failed close is harmless — but the object must be
    defused (mmap/fd detached) or its ``__del__`` would re-raise.
    """
    try:
        seg.close()
    except BufferError:
        seg._buf = None
        seg._mmap = None        # freed by the last exporting view's death
        fd = getattr(seg, "_fd", -1)
        if fd >= 0:
            try:
                os.close(fd)
            except OSError:
                pass
            seg._fd = -1


def _unlink(seg: shared_memory.SharedMemory) -> None:
    _close_quiet(seg)
    try:
        seg.unlink()
    except FileNotFoundError:
        pass


def unlink_segment(name: str) -> None:
    """Best-effort unlink of a segment by name (missing is fine)."""
    try:
        seg = _attach(name)
    except FileNotFoundError:
        return
    _unlink(seg)


def _create(name: str, total: int,
            old: Optional[shared_memory.SharedMemory] = None
            ) -> shared_memory.SharedMemory:
    """A segment of at least ``total`` bytes under ``name``: ``old`` (a
    handle this process holds on the name) or a stale leftover reused when
    large enough, replaced otherwise — recovery replays may legitimately
    re-commit a key."""
    if old is not None:
        if old.size >= total:
            return old
        _unlink(old)
    try:
        return shared_memory.SharedMemory(name=name, create=True,
                                          size=max(total, 1))
    except FileExistsError:
        stale = shared_memory.SharedMemory(name=name)
        if stale.size >= total:
            return stale
        _unlink(stale)
        return shared_memory.SharedMemory(name=name, create=True,
                                          size=max(total, 1))


def _fill(seg: shared_memory.SharedMemory, header: bytes, data) -> None:
    """Write one encoded payload into ``seg``: the header, then the data
    at its aligned offset (a CUDA tensor: one device-to-host copy)."""
    seg.buf[:len(header)] = header
    if data is None:
        return
    off = _aligned(len(header))
    if isinstance(data, np.ndarray):
        if data.nbytes:
            dst = np.frombuffer(seg.buf, dtype=np.uint8, count=data.nbytes,
                                offset=off)
            dst[:] = data.reshape(-1).view(np.uint8)
        return
    nbytes = data.numel() * data.element_size()
    if nbytes:
        dst = torch.from_numpy(np.frombuffer(seg.buf, dtype=np.uint8,
                                             count=nbytes, offset=off))
        t0 = time.perf_counter()
        dst.copy_(data.reshape(-1).view(torch.uint8))
        if data.is_cuda:
            STAGED["seconds"] += time.perf_counter() - t0
            STAGED["to_host"] += nbytes


def _total(header: bytes, data) -> int:
    if data is None:
        return len(header)
    if isinstance(data, np.ndarray):
        return _aligned(len(header)) + data.nbytes
    return _aligned(len(header)) + data.numel() * data.element_size()


def write_segment(name: str, payload: Any) -> int:
    """Create (or reuse) segment ``name`` holding ``payload`` and close
    this process's handle: the frontend seeds a worker this way, and the
    worker adopts the segment.  Returns the payload's accounting nbytes."""
    kind, header, data = _encode(payload)
    seg = _create(name, _total(header, data))
    try:
        _fill(seg, header, data)
    finally:
        _close_quiet(seg)
    return 0 if data is None else _total(header, data) - _aligned(len(header))


class Packed:
    """A payload in the segment encoding, as bytes: how a tensor constant
    crosses the control pipe (importing ``torch`` registers reducers on
    ``multiprocessing``'s pickler that would send a CUDA tensor as an IPC
    handle and move a CPU tensor's storage into shared memory under the
    sender)."""

    __slots__ = ("data",)

    def __init__(self, payload: Any):
        kind, header, data = _encode(payload)
        buf = bytearray(_total(header, data))
        view = memoryview(buf)
        view[:len(header)] = header
        if data is not None:
            off = _aligned(len(header))
            if isinstance(data, np.ndarray):
                view[off:off + data.nbytes] = data.reshape(-1).view(
                    np.uint8).tobytes()
            else:
                flat = data.reshape(-1).view(torch.uint8).cpu()
                view[off:off + flat.numel()] = flat.numpy().tobytes()
        self.data = bytes(buf)

    def __getstate__(self):
        return self.data

    def __setstate__(self, data):
        self.data = data

    def unpack(self) -> Any:
        return _read(memoryview(bytearray(self.data)), copy=True)[1]


def pack(value: Any) -> Any:
    """``value`` ready for the control pipe: a tensor as :class:`Packed`,
    anything else as it is."""
    return Packed(value) if isinstance(value, torch.Tensor) else value


def unpack(value: Any) -> Any:
    return value.unpack() if type(value) is Packed else value


class ShmRef:
    """Frontend-side proxy for a payload living in a worker arena.

    Stored in the executor's virtual stores like any payload; ``nbytes``
    keeps the live-footprint and transfer accounting byte-identical to
    serial replay, and :meth:`materialize` attaches the segment and
    rehydrates the concrete payload when a fetch actually demands it.
    """

    __slots__ = ("key", "rank", "_nb", "session")

    def __init__(self, key: tuple[int, int], rank: int, nb: int,
                 session: str):
        self.key = key
        self.rank = rank
        self._nb = nb
        self.session = session

    @property
    def nbytes(self) -> int:
        return self._nb

    def materialize(self) -> Any:
        """A private copy of the payload (a CUDA tensor on its device)."""
        return read_segment(segment_name(self.session, self.key,
                                         self.rank))[1]

    def view(self) -> tuple[Any, int]:
        """``(payload, bytes_copied)`` with NumPy and CPU-tensor payloads
        zero-copy.

        NumPy segments come back as a *read-only view* of the shared
        mapping and CPU tensors as a view of it (``bytes_copied == 0``):
        the mapping stays alive through the view's buffer reference chain
        even after the segment handle is defused.  A CUDA tensor lands in
        device memory (one host-to-device copy, ``bytes_copied ==
        nbytes``); a pickled object decodes a fresh object (reported as 0,
        matching ``_nbytes``).

        A view aliases the worker-owned segment: if a recovery replay
        re-commits the same version key into the reused segment, a
        still-held old view observes the new bytes — recovery re-commits
        byte-identical payloads, so the aliasing is benign.
        """
        seg = _attach(segment_name(self.session, self.key, self.rank))
        try:
            kind, payload = _read(seg.buf, copy=False)
        finally:
            _close_quiet(seg)
        copied = (self._nb if isinstance(payload, torch.Tensor)
                  and payload.device.type != "cpu" else 0)
        return payload, copied

    def __repr__(self) -> str:
        return f"ShmRef({self.key}, rank {self.rank}, {self._nb}B)"


class WorkerArena:
    """One rank's shared-memory store: version key → owned segment."""

    def __init__(self, session: str, rank: int):
        self.session = session
        self.rank = rank
        self._segments: dict[tuple[int, int], shared_memory.SharedMemory] = {}

    def __contains__(self, key) -> bool:
        return key in self._segments

    def put(self, key: tuple[int, int], payload: Any) -> int:
        """Store ``payload`` under ``key``; returns its accounting nbytes
        (array nbytes; 0 for pickled objects — matching ``_nbytes``)."""
        kind, header, data = _encode(payload)
        total = _total(header, data)
        seg = _create(segment_name(self.session, key, self.rank), total,
                      self._segments.pop(key, None))
        _fill(seg, header, data)
        self._segments[key] = seg
        return 0 if data is None else total - _aligned(len(header))

    def adopt(self, key: tuple[int, int]) -> None:
        """Take ownership of the segment the frontend wrote under this
        rank's name for ``key`` (:func:`write_segment`)."""
        old = self._segments.pop(key, None)
        if old is not None:
            _close_quiet(old)
        self._segments[key] = _attach(
            segment_name(self.session, key, self.rank))

    def view(self, key: tuple[int, int]) -> Any:
        """The payload of an owned segment: NumPy and CPU tensors as
        zero-copy views, a CUDA tensor copied onto its device."""
        return _read(self._segments[key].buf, copy=False)[1]

    def pull(self, key: tuple[int, int], src_rank: int) -> int:
        """Ship: memcpy ``(key, src_rank)``'s segment into this arena."""
        src = _attach(segment_name(self.session, key, src_rank))
        try:
            total = src.size
            seg = _create(segment_name(self.session, key, self.rank), total,
                          self._segments.pop(key, None))
            seg.buf[:total] = src.buf[:total]
            self._segments[key] = seg
            return total
        finally:
            _close_quiet(src)

    def drop(self, key: tuple[int, int]) -> None:
        seg = self._segments.pop(key, None)
        if seg is not None:
            _unlink(seg)

    def clear(self) -> None:
        for key in list(self._segments):
            self.drop(key)


class BarrierAborted(RuntimeError):
    """Raised in a worker when the frontend aborts the wavefront barrier."""


class ShmBarrier:
    """Sense-reversing spin barrier over shared ctypes, resizable + abortable.

    ``multiprocessing.Barrier`` cannot shrink its party count after spawn,
    which elastic degradation (a permanently dead worker) requires; this
    one keeps ``parties`` in shared memory so the frontend can resize it
    between plans, and exposes :meth:`abort` so survivors of a killed
    worker unblock deterministically instead of deadlocking on a barrier
    the dead rank will never reach.  Waiters spin with a short yield-then-
    sleep backoff (wavefront levels are the unit of synchronisation, so
    waits are µs–ms scale).
    """

    def __init__(self, ctx, parties: int):
        self._lock = ctx.Lock()
        self._parties = ctx.RawValue("i", parties)
        self._count = ctx.RawValue("i", 0)
        self._gen = ctx.RawValue("Q", 0)
        self._abort = ctx.RawValue("b", 0)

    def wait(self, timeout: float = 120.0, poke=None) -> None:
        with self._lock:
            gen = self._gen.value
            self._count.value += 1
            if self._count.value >= self._parties.value:
                self._count.value = 0
                self._gen.value = gen + 1
                return
        deadline = time.monotonic() + timeout
        spins = 0
        while self._gen.value == gen:
            if self._abort.value:
                raise BarrierAborted("wavefront barrier aborted")
            if time.monotonic() > deadline:
                raise BarrierAborted("wavefront barrier timed out")
            spins += 1
            if spins < 200:
                time.sleep(0)
            else:
                time.sleep(0.0002)
                if poke is not None:
                    poke()

    # -- frontend-side control ------------------------------------------------
    def abort(self) -> None:
        self._abort.value = 1

    def resize(self, parties: int) -> None:
        with self._lock:
            self._parties.value = parties

    def reset(self, parties: int) -> None:
        """Re-arm after an abort; callers guarantee no worker is waiting."""
        with self._lock:
            self._parties.value = parties
            self._count.value = 0
            self._abort.value = 0
