"""Replay a tier-1 run's junit through pytest-xdist's `--dist loadfile`
schedule, to see what sets the run's wall time.

Not a test. pytest-xdist (3.x) queues the files by their test count, most
first (ties in collection order), hands each of the `-n` workers one file,
and gives a worker the next file whenever its pending tests (the running
one included) fall to 2 or fewer. So a worker that starts a two-test file
at once takes the next file in the queue behind it. This script replays
that rule with each test's junit time, and with `--noise` it draws each
file's time from +-noise around it to show the spread of the wall time:

    python tests/tier1_schedule.py run.xml
    python tests/tier1_schedule.py run.xml --noise 0.15 --scale test_torch_=0.8

`--scale NAME=F` multiplies the time of every file whose path holds NAME
by F (0 removes the file). The replay leaves out the workers' collection
(~25 s on one core).
"""

from __future__ import annotations

import argparse
import collections
import heapq
import random
import xml.etree.ElementTree as ET

WORKERS = 6  # tier-1's `-n 6`
DRAWS = 400


def load(path: str) -> dict[str, list[float]]:
    """{test file: [each test's junit time, in collection order]}."""
    files: dict[str, list[float]] = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname").split(".")
        files.setdefault("/".join(parts[:2]) + ".py", []).append(
            float(case.get("time")))
    return files


def replay(files: dict[str, list[float]],
           scale: dict[str, float] | None = None,
           workers: int = WORKERS) -> tuple[float, list]:
    """-> (wall time, each worker's files in the order it took them)."""
    scale = scale or {}
    units = [(f, [t * scale.get(f, 1.0) for t in files[f]])
             for f in sorted(files)]
    units.sort(key=lambda u: -len(u[1]))  # stable: ties keep their order
    queue = collections.deque(units)
    pending = [collections.deque() for _ in range(workers)]
    taken = [[] for _ in range(workers)]

    def take(i):
        if queue:
            name, times = queue.popleft()
            pending[i].extend(times)
            taken[i].append(name)

    for i in range(workers):
        take(i)
    for i in range(workers):
        if len(pending[i]) <= 2:
            take(i)
    events = [(pending[i][0], i) for i in range(workers) if pending[i]]
    heapq.heapify(events)
    wall = 0.0
    while events:
        now, i = heapq.heappop(events)
        pending[i].popleft()
        wall = now
        if len(pending[i]) <= 2:
            take(i)
        if pending[i]:
            heapq.heappush(events, (now + pending[i][0], i))
    return wall, taken


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("junit")
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--scale", action="append", default=[])
    args = ap.parse_args()
    files = load(args.junit)
    factors = [(k, float(v)) for k, v in (s.split("=") for s in args.scale)]
    scale = {f: f_ for f in files for k, f_ in factors if k in f}
    total = sum(map(sum, files.values()))
    port = sum(sum(v) for f, v in files.items() if "test_torch_" in f)
    print(f"worker time {total:.1f} s (test_torch_* files {port:.1f} s)")
    wall, taken = replay(files, scale)
    print(f"replayed wall {wall:.1f} s; each worker's last files:")
    for i, names in enumerate(taken):
        print(f"  {i}: {', '.join(n.split('/')[-1] for n in names[-3:])}")
    if args.noise:
        walls = []
        for d in range(DRAWS):
            rng = random.Random(d)
            drawn = {f: scale.get(f, 1.0) * rng.uniform(1 - args.noise,
                                                        1 + args.noise)
                     for f in files}
            walls.append(replay(files, drawn)[0])
        walls.sort()
        q = [walls[int(p * (len(walls) - 1))] for p in (0.1, 0.5, 0.9)]
        print(f"+-{args.noise:g} a file, {DRAWS} draws: wall 10% "
              f"{q[0]:.0f} s, median {q[1]:.0f} s, 90% {q[2]:.0f} s")


if __name__ == "__main__":
    main()
