"""Run ``chip_smoke.py`` from each given checkout in turn, on one card,
and stamp every line of its output with the seconds since that run began.

Usage, from the root of the repository::

    python3 tools/smoke_walls.py build/parent build/this

Each checkout's stamped output goes to ``chiprun_out/walls_<name>.log``
(``<name>`` the checkout directory's name); this prints the card, each
run's exit code and the second at which each section's first line came.
Two checkouts in one call share one host, so their sections' seconds
compare where two calls' would not: a section present in only one side,
or one that grew, shows its own cost.
"""

from __future__ import annotations

import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import gpu_name_and_power  # noqa: E402

# a section's name: the bracketed tag a line starts with
TAG = re.compile(r"^(\[[^\]]+\])")


def stamped_run(checkout: Path, log: Path) -> int:
    """Run the checkout's chip_smoke.py; write each output line to ``log``
    after the seconds since the start.  Gives back the exit code."""
    t0 = time.perf_counter()
    with subprocess.Popen([sys.executable, "-u", "chip_smoke.py"],
                          cwd=checkout, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True) as proc, \
            open(log, "w") as out:
        for line in proc.stdout:
            out.write(f"{time.perf_counter() - t0:9.3f} {line}")
            out.flush()
    return proc.returncode


def first_seconds(log: Path) -> dict:
    """Each section tag's first second in a stamped log."""
    first = {}
    for line in log.read_text().splitlines():
        stamp, _, text = line.strip().partition(" ")
        match = TAG.match(text)
        if match and match.group(1) not in first:
            first[match.group(1)] = float(stamp)
    return first


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("smoke_walls: no card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    print(f"[walls] card: {gpu_name_and_power()}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    failed = 0
    for arg in sys.argv[1:]:
        checkout = Path(arg).resolve()
        log = out_dir / f"walls_{checkout.name}.log"
        rc = stamped_run(checkout, log)
        failed |= rc != 0
        print(f"[walls] {checkout.name}: exit {rc}, log {log.name}")
        for tag, sec in first_seconds(log).items():
            print(f"[walls]   {checkout.name} {tag} first at {sec:.3f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
