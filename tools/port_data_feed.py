#!/usr/bin/env python3
"""The host side of the data library's image feed (``ray_tpu_torch.data``),
on any host.

    python tools/port_data_feed.py [--images 4096] [--blocks 64] [--passes 2]
    RAY_TPU_TORCH_DISABLE_PREFAULT=1 python tools/port_data_feed.py

Run from the root of a checkout. The dataset is ``chip_smoke.py``'s phase
``data_feed_vit`` without the card: ``range`` -> ``map_batches`` tasks that
make seeded uint8 images of 224x224x3 -> ``iter_batches(batch_size=256)`` in
this process (the step before ``iter_torch_batches`` stages a batch for its
copy). Prints one JSON object: per pass, images/s and the ms each batch
waited for. The first pass starts the tasks' workers and first touches the
store's arena, whose background prefault the second line above turns off.
No card is used; the numbers are the host's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(block):
    import numpy as np

    ids = block["id"]
    rng = np.random.default_rng([11, int(ids[0])])
    return {"image": rng.integers(0, 256, (len(ids), 224, 224, 3), dtype=np.uint8)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=4096)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--num-cpus", type=int, default=os.cpu_count())
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import ray_tpu_torch as R

    R.init(num_cpus=args.num_cpus, object_store_memory=2 * 1024**3)
    try:
        ds = R.data.range(args.images, num_blocks=args.blocks).map_batches(_images)
        passes = []
        for _ in range(args.passes):
            waits, n = [], 0
            t0 = time.perf_counter()
            it = iter(ds.iter_batches(batch_size=args.batch))
            while True:
                t1 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                waits.append(round((time.perf_counter() - t1) * 1e3, 3))
                n += len(batch["image"])
            seconds = time.perf_counter() - t0
            passes.append({"images_per_s": n / seconds, "seconds": seconds, "wait_ms": waits})
    finally:
        R.shutdown()
    print(json.dumps({"host_cpus": os.cpu_count(), "num_cpus": args.num_cpus,
                      "prefault": not os.environ.get("RAY_TPU_TORCH_DISABLE_PREFAULT"),
                      "passes": passes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
