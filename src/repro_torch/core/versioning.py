"""Multi-version concurrency control (MVCC) for the Bind programming model.

The paper (§II-B) builds its transactional DAG on *object versioning*: every
mutation of an object creates a new immutable *version*, and every operation
records exactly which versions it reads and which it generates.  Because a
version can never change after creation, race conditions are impossible by
construction and execution is reproducible.

Op bodies return new payloads instead of mutating their inputs, so MVCC is
the natural semantics even for mutable ``torch.Tensor`` payloads — this
module makes the version graph *explicit* so the scheduler can (a) extract the
transactional DAG, (b) infer implicit collectives from the queue of consumers
of a version (paper §III "implicit collectives"), and (c) keep multiple live
versions so that newer operations need not wait on older ones.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import torch

# Global monotone id streams.  Determinism matters: the paper requires every
# process to reconstruct the *identical* DAG from the same sequential trace,
# so ids must be a pure function of trace order (no randomness, no id()).
_REF_IDS = itertools.count()


@dataclasses.dataclass(frozen=True)
class Version:
    """One immutable state of a :class:`Ref`.

    ``producer`` is the op id that generated this version (``-1`` for the
    initial version materialised from user data).  ``index`` is the position
    in the ref's history; ``(ref_id, index)`` is globally unique.
    """

    ref_id: int
    index: int
    producer: int

    @property
    def key(self) -> tuple[int, int]:
        return (self.ref_id, self.index)

    def __repr__(self) -> str:  # compact for DAG dumps
        return f"v{self.ref_id}.{self.index}"


class Ref:
    """A versioned object handle (the paper's "object").

    A ``Ref`` owns a linear history of :class:`Version` s.  Readers pin a
    specific version; writers append a new one.  The payloads themselves are
    stored by the executor, keyed by ``Version.key`` — the handle is pure
    metadata, which is what makes the workflow "global": every process can
    reconstruct the same metadata without holding the data.
    """

    __slots__ = ("ref_id", "versions", "meta", "name")

    def __init__(self, name: str = "", meta: Any = None, first_producer: int = -1):
        self.ref_id = next(_REF_IDS)
        self.versions: list[Version] = [Version(self.ref_id, 0, first_producer)]
        self.meta = meta  # shape/dtype or arbitrary descriptor
        self.name = name or f"ref{self.ref_id}"

    @property
    def head(self) -> Version:
        return self.versions[-1]

    def new_version(self, producer: int) -> Version:
        # index continues from the head, not from len(versions): a
        # compacted ref (history truncated to its live suffix) must keep
        # issuing monotonically fresh indices — (ref_id, index) keys are
        # never reused
        v = Version(self.ref_id, self.versions[-1].index + 1, producer)
        self.versions.append(v)
        return v

    def version(self, index: int) -> Version:
        """The version with history index ``index`` (offset-aware: valid
        after :meth:`compact` for any retained index)."""
        pos = index - self.versions[0].index
        if 0 <= pos < len(self.versions) and self.versions[pos].index == index:
            return self.versions[pos]
        for v in self.versions:      # sparse retained history post-compact
            if v.index == index:
                return v
        raise IndexError(f"version {index} of ref {self.ref_id} was compacted")

    def compact(self, keep=()) -> int:
        """Drop superseded versions not in ``keep`` (a set of *indices*).

        Trace compaction calls this once the executed prefix of a workflow
        is truncated: superseded versions can never gain new readers, so
        only the head (still fetchable / readable by future ops) and any
        version a not-yet-executed op still reads need to survive.  Returns
        the number of versions dropped.  Version *indices* are preserved —
        only the history list shrinks — so existing keys stay valid.
        """
        if len(self.versions) == 1:
            return 0
        kept = [v for v in self.versions[:-1] if v.index in keep]
        kept.append(self.versions[-1])
        dropped = len(self.versions) - len(kept)
        if dropped:
            self.versions = kept
        return dropped

    def __repr__(self) -> str:
        return f"Ref({self.name}, head={self.head})"


def reset_ids() -> None:
    """Reset the global id streams (tests / fresh traces)."""
    global _REF_IDS
    _REF_IDS = itertools.count()



class VersionStore:
    """Payload storage for versions, with refcount-based reclamation.

    Mirrors the paper's note that multi-versioning costs memory proportional
    to the exposed parallelism, "with smart memory reusage to mitigate the
    overhead when possible": once every consumer of a version has executed,
    its payload is dropped (unless it is a live head the user may still
    read).  Payloads are kept as given (tensors on their device, NumPy
    arrays on the host); :attr:`live_bytes` counts a tensor's
    ``numel × element_size`` and a NumPy array's ``nbytes``.
    """

    def __init__(self):
        self._data: dict[tuple[int, int], Any] = {}
        self._pending_readers: dict[tuple[int, int], int] = {}
        self._pinned: set[tuple[int, int]] = set()
        self.peak_live = 0

    def put(self, version: Version, value: Any) -> None:
        self._data[version.key] = value
        self.peak_live = max(self.peak_live, len(self._data))

    def get(self, version: Version) -> Any:
        return self._data[version.key]

    def has(self, version: Version) -> bool:
        return version.key in self._data

    def pin(self, version: Version) -> None:
        """Prevent reclamation (live heads visible to user code)."""
        self._pinned.add(version.key)

    def add_reader(self, version: Version, n: int = 1) -> None:
        k = version.key
        self._pending_readers[k] = self._pending_readers.get(k, 0) + n

    def release_reader(self, version: Version) -> None:
        k = version.key
        left = self._pending_readers.get(k, 0) - 1
        self._pending_readers[k] = left
        if left <= 0 and k not in self._pinned and k in self._data:
            del self._data[k]

    @property
    def live_bytes(self) -> int:
        total = 0
        for v in self._data.values():
            if isinstance(v, torch.Tensor):
                total += v.numel() * v.element_size()
                continue
            nbytes = getattr(v, "nbytes", None)
            if nbytes is not None:
                total += int(nbytes)
        return total
