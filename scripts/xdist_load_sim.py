#!/usr/bin/env python3
"""Replay pytest-xdist's `--dist load` scheduling over measured durations.

    python3 scripts/xdist_load_sim.py COLLECTION JUNIT_XML [--workers 6] [--extra N]

COLLECTION is the output of `pytest tests/ -q -m 'not slow' --collect-only`
(one test id a line, in collection order); JUNIT_XML the report of a run
with `--junitxml`, whose per-test times stand for each test's duration.
The script replays xdist 3.8's LoadScheduling: each worker first gets one
chunk of N // workers // 4 consecutive tests, then, whenever a worker runs
short, the next tests in collection order. It prints each worker's initial
chunk (first and last file, seconds), the simulated wall time (the latest
worker's finish) and each worker's finish, and with `--extra N` the same for
N more tests of the median duration appended at the position of the first
`test_torch_` file, so the wall time's dependence on the test count shows.
Worker crashes and the per-worker start-up are not modelled.
"""

from __future__ import annotations

import argparse
import heapq
import statistics
import xml.etree.ElementTree as ET


def durations(junit_path: str) -> dict:
    out = {}
    for tc in ET.parse(junit_path).getroot().iter("testcase"):
        parts = tc.get("classname").split(".")
        test_id = "/".join(parts[:2]) + ".py::" + "::".join(parts[2:] + [tc.get("name")])
        out[test_id] = float(tc.get("time") or 0.0)
    return out


def simulate(times: list, workers: int) -> list:
    """Each worker's finish time under LoadScheduling (durations in
    collection order)."""
    pending = list(range(len(times)))
    queues = [[] for _ in range(workers)]
    chunk = max(min(len(times) // workers // 4, len(times)), 2)
    for q in queues:
        q += pending[:chunk]
        del pending[:chunk]
    events = [(times[q[0]], w) for w, q in enumerate(queues) if q]
    heapq.heapify(events)
    finish = [0.0] * workers
    while events:
        now, w = heapq.heappop(events)
        done = queues[w].pop(0)
        finish[w] = now
        if pending:
            lo = max(2, len(pending) // workers // 4)
            hi = max(2, len(pending) // workers // 2)
            q = queues[w]
            # xdist waits when a worker on long tests still holds two
            if len(q) < lo and not (times[done] >= 0.1 and len(q) >= 2):
                n = hi - len(q)
                q += pending[:n]
                del pending[:n]
        if queues[w]:
            heapq.heappush(events, (now + times[queues[w][0]], w))
    return finish


def report(items: list, dur: dict, workers: int, label: str) -> None:
    fill = statistics.median(dur.values()) if dur else 0.0
    times = [dur.get(i, fill) for i in items]
    chunk = max(len(items) // workers // 4, 2)
    print(f"{label}: {len(items)} tests, initial chunk {chunk}")
    for w in range(workers):
        seg = items[w * chunk:(w + 1) * chunk]
        secs = sum(times[w * chunk:(w + 1) * chunk])
        print(f"  worker {w}: {seg[0].split('::')[0]} .. {seg[-1].split('::')[0]}: {secs:.0f} s")
    finish = simulate(times, workers)
    print(f"  wall {max(finish):.0f} s; workers {[round(f) for f in finish]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("collection")
    ap.add_argument("junit")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--extra", type=int, default=0)
    args = ap.parse_args()
    items = [ln.strip() for ln in open(args.collection) if "::" in ln]
    dur = durations(args.junit)
    missing = [i for i in items if i not in dur]
    if missing:
        print(f"{len(missing)} tests have no duration in the report (median used): "
              f"{missing[:3]}")
    report(items, dur, args.workers, "as collected")
    if args.extra:
        at = next(j for j, i in enumerate(items) if "test_torch_" in i)
        more = items[:at] + [f"extra::{k}" for k in range(args.extra)] + items[at:]
        report(more, dur, args.workers, f"with {args.extra} more tests")


if __name__ == "__main__":
    main()
