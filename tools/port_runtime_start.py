#!/usr/bin/env python3
"""Start-up costs of the port's core runtime (``ray_tpu_torch``), on any host.

    python tools/port_runtime_start.py [--repeats 3]

Run from the root of a checkout. Prints one JSON object: the seconds a fresh
interpreter takes to import ``torch`` and to import ``ray_tpu_torch`` (the
forkserver's preload imports the package, and with it torch), ``init`` in ms,
the first task's round trip (its worker may still be starting), a warm task's
and an actor call's round trip, and the time from ``.remote()`` to the first
answer of actors that each need a freshly forked worker (once the idle
workers ``init`` prestarts are taken). Each number is the
median of ``--repeats`` fresh processes. No card is used.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT = "import time; t = time.perf_counter(); import {mod}; print(time.perf_counter() - t)"

_RUNTIME = r"""
import json, time
import ray_tpu_torch as R

t = time.perf_counter()
R.init(num_cpus=2)
init_ms = (time.perf_counter() - t) * 1e3

@R.remote
def echo(x):
    return x

@R.remote(num_cpus=0)
class Actor:
    def echo(self, x):
        return x

t = time.perf_counter()
R.get(echo.remote(0), timeout=120)
first_task_ms = (time.perf_counter() - t) * 1e3
t = time.perf_counter()
for i in range(50):
    R.get(echo.remote(i), timeout=60)
task_ms = (time.perf_counter() - t) * 1e3 / 50
# two actors take the idle workers init prestarted; each later one needs a
# fresh fork from the forkserver's template
actors = [Actor.remote() for _ in range(2)]
R.get([a.echo.remote(0) for a in actors], timeout=120)
spawn_ms = []
for _ in range(3):
    t = time.perf_counter()
    a = Actor.remote()
    R.get(a.echo.remote(0), timeout=120)
    spawn_ms.append((time.perf_counter() - t) * 1e3)
    actors.append(a)
t = time.perf_counter()
for i in range(50):
    R.get(actors[0].echo.remote(i), timeout=60)
actor_ms = (time.perf_counter() - t) * 1e3 / 50
R.shutdown()
print(json.dumps(dict(init_ms=init_ms, first_task_ms=first_task_ms, task_round_trip_ms=task_ms,
                      actor_start_ms=spawn_ms, actor_call_round_trip_ms=actor_ms)))
"""


def _run(code: str) -> str:
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, check=True)
    return r.stdout.strip().splitlines()[-1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    imports = {mod: statistics.median(float(_run(_IMPORT.format(mod=mod)))
                                      for _ in range(args.repeats))
               for mod in ("torch", "ray_tpu_torch")}
    runs = [json.loads(_run(_RUNTIME)) for _ in range(args.repeats)]
    out = {"host_cpus": os.cpu_count(), "repeats": args.repeats,
           "import_s": imports}
    for key in runs[0]:
        vals = [r[key] for r in runs]
        out[key] = (statistics.median(vals) if not isinstance(vals[0], list)
                    else [statistics.median(v[i] for v in vals) for i in range(len(vals[0]))])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
