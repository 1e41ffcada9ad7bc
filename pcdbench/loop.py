"""The one traffic generator: requests back to back from one client (a
closed loop), shaped by a traffic file's parameters.

A traffic file ``traffic/<name>.json`` holds

    {"clients": 1,            # requests in flight (a closed loop: 1)
     "warmup_steps": 1,       # Picard steps of set-up's warm-up
     "profile_requests": 1}   # whole requests under the profiler (--trace 1)

The window starts requests while its clock is short of ``--seconds``; the
request in flight when it gets there completes and counts.  Every request
is timed whole, and each of its steps between the program's step marks.
Memory is left to the program and to Python's own collector, as in a
user's loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List


@dataclasses.dataclass
class Window:
    t0: float                      # perf_counter at the first request
    wall_s: float                  # first request's start to last's end
    records: List[object]          # the requests' records, in order
    step_s: List[float]            # every step of every request
    request_s: List[float]         # every request, whole


def closed_loop(target, seconds: float, traffic: dict, sync) -> Window:
    """Requests of ``target.solve(mark)`` back to back for ``seconds``;
    ``sync()`` waits for the device before the clock starts."""
    if int(traffic.get("clients", 1)) != 1:
        raise ValueError("the closed loop holds one request in flight")
    sync()
    records, steps, whole = [], [], []
    t0 = time.perf_counter()
    end = t0
    while end - t0 < seconds:
        marks = [time.perf_counter()]
        rec = target.solve(lambda: marks.append(time.perf_counter()))
        end = time.perf_counter()
        steps.extend(b - a for a, b in zip(marks, marks[1:]))
        whole.append(end - marks[0])
        records.append(rec)
    return Window(t0=t0, wall_s=end - t0, records=records, step_s=steps,
                  request_s=whole)
