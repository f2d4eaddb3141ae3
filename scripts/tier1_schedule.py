"""The tier-1 run's schedule, simulated (no tests here).

The tier-1 command runs ``pytest -n 6 --dist loadfile``. pytest-xdist 3.8
hands whole files out sorted by their collected test count, largest first,
ties in collection order (``xdist/scheduler/loadscope.py:376-378``); each
worker first gets one file, then a second where its first holds at most 2
tests, and afterwards takes the next file whenever its pending tests fall
to 2 (``:330-336``). This replays that rule on the per-test times of a
junit XML, so a layout of the test files can be judged before a run:

    python scripts/tier1_schedule.py RUN.xml [OVERLAY.xml ...]

Files found in an overlay replace the base run's files of the same name
(for example the port's files timed in a later run). It prints the wall
of the simulated schedule, each worker's files with their start times, and
the mean, 90th percentile and maximum wall over 2 x 1000 draws in which
every file's times are scaled by one factor uniform in [0.85, 1.15].
"""

from __future__ import annotations

import collections
import heapq
import random
import sys
import xml.etree.ElementTree as ET

WORKERS = 6


def load(*paths: str) -> dict:
    """Per-file lists of test times (collection order) from junit XMLs,
    later files replacing earlier ones."""
    files: dict = {}
    for path in paths:
        run = collections.OrderedDict()
        for case in ET.parse(path).getroot().iter("testcase"):
            name = case.get("classname").split(".")[-1]
            run.setdefault(name, []).append(float(case.get("time")))
        files.update(run)
    return files


def simulate(files: dict, workers: int = WORKERS, log: list | None = None
             ) -> float:
    """The wall of xdist's loadfile schedule over ``files``; with ``log``,
    each worker's (file, start) list is appended to it."""
    queue = sorted(sorted(files), key=lambda f: -len(files[f]))
    pending = [collections.deque() for _ in range(workers)]
    started = [[] for _ in range(workers)]

    def assign(w, t):
        name = queue.pop(0)
        started[w].append((name, t))
        pending[w].extend(files[name])

    for w in range(workers):
        if queue:
            assign(w, 0.0)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            assign(w, 0.0)
    events = [(pending[w].popleft(), w) for w in range(workers)
              if pending[w]]
    heapq.heapify(events)
    end = [0.0] * workers
    while events:
        t, w = heapq.heappop(events)
        end[w] = t
        if queue and len(pending[w]) <= 2:
            assign(w, t)
        if pending[w]:
            heapq.heappush(events, (t + pending[w].popleft(), w))
    if log is not None:
        log.extend(started)
    return max(end)


def noisy_walls(files: dict, seed: int, draws: int = 1000) -> list:
    rng = random.Random(seed)
    walls = []
    for _ in range(draws):
        scaled = {}
        for name, times in files.items():
            k = rng.uniform(0.85, 1.15)
            scaled[name] = [k * t for t in times]
        walls.append(simulate(scaled))
    return sorted(walls)


def main(paths: list) -> None:
    files = load(*paths)
    log: list = []
    wall = simulate(files, log=log)
    print(f"simulated wall {wall:.1f} s over {sum(map(len, files.values()))}"
          f" tests, {sum(map(sum, files.values())):.1f} s of test time")
    for w, started in enumerate(log):
        print(f"  worker {w}: " + ", ".join(f"{n}@{t:.0f}"
                                           for n, t in started))
    for seed in (99, 7):
        ws = noisy_walls(files, seed)
        print(f"noise seed {seed}: mean {sum(ws) / len(ws):.1f} s, p90 "
              f"{ws[int(0.9 * len(ws))]:.1f} s, max {ws[-1]:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
