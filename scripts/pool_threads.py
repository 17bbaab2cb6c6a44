#!/usr/bin/env python3
"""Host rate of the tf-recipe TFRecord pipeline (``data.tfrecords``) with
torch's intra-op threads under each pool worker left at torch's default
or set to 1.

    python3 scripts/pool_threads.py default|one [--seconds 4]

Each arm runs in a fresh process: ``torch.set_num_threads`` in one thread
also sets the count that threads started later in the process take, so two
arms cannot share a process.  The run writes the bench shards once
(``bench_data.ensure_bench_shards``: 1024 ILSVRC-size JPEGs in 8 shards,
into the port's git-ignored ``_build/bench-shards``), then draws training
batches of 64 at 224 px on the host alone (no device): the first batch
untimed, then at least ``--seconds`` and 8 batches timed.  It prints one
JSON line: the arm, img/s, batches, seconds, the pool's width and the
host's cores.  Run the arms in the order default one one default and
compare them within one machine."""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arm", choices=["default", "one"])
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from distributeddeeplearning_tpu_torch.data import tfrecords
    from distributeddeeplearning_tpu_torch.data.bench_data import ensure_bench_shards

    data = ensure_bench_shards(None, num_images=1024, num_shards=8)
    if args.arm == "one":
        tfrecords.ThreadPoolExecutor = functools.partial(
            ThreadPoolExecutor, initializer=torch.set_num_threads, initargs=(1,))
    it = tfrecords.input_fn(data, True, 64, image_size=224, seed=0,
                            shard_count=1, shard_index=0)
    t0 = time.perf_counter()
    next(it)
    warm = time.perf_counter() - t0
    images = batches = 0
    dt = 0.0
    t1 = time.perf_counter()
    while batches < 8 or dt < args.seconds:
        images += len(next(it)["label"])
        batches += 1
        dt = time.perf_counter() - t1
    it.close()
    print(json.dumps({"arm": args.arm, "img_s": images / dt, "batches": batches,
                      "seconds": dt, "warmup_s": warm,
                      "workers": tfrecords.default_workers(),
                      "cpu_count": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
