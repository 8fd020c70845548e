#!/usr/bin/env python3
"""Predicted wall of a pytest-xdist ``--dist load`` run from measured test
times.

    python3 tools/xdist_tail.py RUN.xml ORDER.txt [--workers 6]
                                [--drop PATTERN ...] [--trials 60]
                                [--sigma 0.15] [--seed 0]

``RUN.xml`` is a junit report of an earlier run (``--junitxml``): each
test's time (setup, call and teardown). ``ORDER.txt`` is the collection
order, one node id a line (``pytest --collect-only -q``). The script
replays xdist's ``LoadScheduling`` (pytest-xdist 3.8: every worker first
takes a quarter of its share of consecutive tests; a worker whose queue
drops below a quarter of its share of what is pending is filled to half
of it, unless its last test took 0.1 s or more and two tests are still
queued) with each test taking its measured time, and prints one JSON
line: the predicted wall (worker start-up not counted), each worker's
finish, and the tests the last worker ran in its final 300 s. With
``--trials`` > 0 it then repeats the replay with every time multiplied by
a log-normal factor (``--sigma``), for the tree as ordered and for the
tree without the node ids matching any ``--drop`` pattern, and prints
the deciles of both: how far the tail moves with run-to-run noise, and
what a set of tests changes in it. Tests without a time in the report
take 0 s.
"""

from __future__ import annotations

import argparse
import heapq
import json
import random
import re
import statistics
import xml.etree.ElementTree as ET


def durations(path: str) -> dict[str, float]:
    """node id -> seconds, from a junit report."""
    root = ET.parse(path).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    out = {}
    for tc in suite.iter("testcase"):
        parts = (tc.get("classname") or "").split(".")
        nid = f"{'/'.join(parts[:2])}.py::" + "::".join(
            parts[2:] + [tc.get("name")])
        out[nid] = float(tc.get("time", 0.0))
    return out


def replay(order: list[str], dur: dict[str, float], workers: int):
    """xdist's load scheduling over ``order``; returns (wall, per-worker
    finish, [(start, end, worker, node id)])."""
    pending = list(range(len(order)))
    queue = {w: [] for w in range(workers)}

    def send(w, num):
        nonlocal pending
        queue[w].extend(pending[:num])
        pending = pending[num:]

    for w in range(workers):
        send(w, max(len(order) // workers // 4, 2))
    heap, running, log = [], {}, []
    finish = [0.0] * workers

    def start(w, t0):
        if queue[w]:
            i = queue[w][0]
            running[w] = (i, t0)
            heapq.heappush(heap, (t0 + dur.get(order[i], 0.0), w))

    for w in range(workers):
        start(w, 0.0)
    while heap:
        now, w = heapq.heappop(heap)
        i, t0 = running.pop(w)
        queue[w].remove(i)
        log.append((t0, now, w, order[i]))
        finish[w] = now
        if pending:
            lo = max(2, len(pending) // workers // 4)
            hi = max(2, len(pending) // workers // 2)
            long_last = dur.get(order[i], 0.0) >= 0.1
            if len(queue[w]) < lo and not (long_last and len(queue[w]) >= 2):
                send(w, hi - len(queue[w]))
        start(w, now)
    return max(finish), finish, log


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("report")
    ap.add_argument("order")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--drop", nargs="*", default=[])
    ap.add_argument("--trials", type=int, default=60)
    ap.add_argument("--sigma", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dur = durations(args.report)
    with open(args.order) as f:
        order = [ln.strip() for ln in f if "::" in ln]
    wall, finish, log = replay(order, dur, args.workers)
    last = max(range(args.workers), key=lambda w: finish[w])
    tail = [(round(a, 1), round(b - a, 1), nid) for a, b, w, nid in log
            if w == last and b > wall - 300 and b - a >= 5]
    print(json.dumps(dict(tests=len(order), wall_s=round(wall, 1),
                          worker_finish_s=[round(x, 1) for x in finish],
                          tail=tail)))
    if args.trials <= 0:
        return 0
    drop = [re.compile(p) for p in args.drop]
    kept = [nid for nid in order if not any(p.search(nid) for p in drop)]
    rng = random.Random(args.seed)
    walls = {"as_ordered": [], "dropped": []}
    for _ in range(args.trials):
        noisy = {k: v * rng.lognormvariate(0.0, args.sigma)
                 for k, v in dur.items()}
        walls["as_ordered"].append(replay(order, noisy, args.workers)[0])
        walls["dropped"].append(replay(kept, noisy, args.workers)[0])
    print(json.dumps({k: dict(tests=len(order if k == "as_ordered" else kept),
                              median_s=round(statistics.median(v), 1),
                              deciles_s=[round(x, 1) for x in
                                         statistics.quantiles(v, n=10)])
                      for k, v in walls.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
