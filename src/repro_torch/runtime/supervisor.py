"""Node-failure handling: respawn-on-crash + heartbeat hang detection
(``repro/runtime/supervisor.py``, plain Python, copied).

On a real fleet each host runs under a supervisor like this one; combined
with atomic checkpoints and the pure-function data pipeline, any crash /
hang converges back to the last committed step with zero coordination.
Straggler note (DESIGN.md §7): *within* a step SPMD admits no stragglers —
the slowest chip gates the collective — so cross-step protection (hang
watchdog, async checkpointing, skip-ahead data) is the whole game.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Optional, Sequence


class Supervisor:
    def __init__(
        self,
        argv: Sequence[str],
        *,
        heartbeat_file: str,
        heartbeat_timeout: float = 300.0,
        max_restarts: int = 10,
        env: Optional[dict] = None,
    ):
        self.argv = list(argv)
        self.heartbeat_file = heartbeat_file
        self.heartbeat_timeout = heartbeat_timeout
        self.max_restarts = max_restarts
        self.env = env
        self.restarts = 0
        self._spawned_at: Optional[float] = None

    def _heartbeat_age(self) -> float:
        return heartbeat_age(self.heartbeat_file, self._spawned_at)

    def run(self, poll: float = 1.0) -> int:
        """Run the training process, respawning on crash or hang.
        Returns the final (clean) exit code."""
        while True:
            proc = subprocess.Popen(self.argv, env=self.env)
            self._spawned_at = time.time()
            hung = False
            while True:
                ret = proc.poll()
                if ret is not None:
                    break
                if self._heartbeat_age() > self.heartbeat_timeout:
                    proc.kill()
                    proc.wait()
                    ret = -9
                    hung = True
                    break
                time.sleep(poll)
            if ret == 0 and not hung:
                return 0
            self.restarts += 1
            if self.restarts > self.max_restarts:
                raise RuntimeError(
                    f"gave up after {self.max_restarts} restarts "
                    f"(last exit {ret}, hung={hung})")
            # training script resumes from the latest checkpoint on its own


def heartbeat_age(path: str, spawned_at: Optional[float] = None) -> float:
    """Seconds since ``path`` was last touched.

    The shared liveness predicate for every heartbeat consumer — the
    :class:`Supervisor` loop for whole training processes, and the
    process-pool backend's per-rank worker monitor.  No heartbeat file yet:
    a worker that dies into a zombie (or hangs) before its *first*
    heartbeat used to report age 0.0 forever and was never detected — count
    age from the spawn instead, so the timeout covers the
    pre-first-heartbeat window.
    """
    try:
        return time.time() - os.path.getmtime(path)
    except OSError:
        if spawned_at is None:
            return 0.0
        return time.time() - spawned_at


def touch_heartbeat(path: str) -> None:
    with open(path, "a"):
        os.utime(path, None)
