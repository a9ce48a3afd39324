#!/usr/bin/env python3
"""Where config 4's prefetched step goes: chip_smoke.py phase 17(a)'s
ResNet-50 (bf16 NHWC, Nesterovs(0.1, 0.9), batch 128) over 14(a)'s 9
batches, fed eleven ways in one process, each twice (in order, then in
reverse), from one start. Through ``fit``:

- ``resident``: the 9 batches already on the card (no host data work:
  the step's own floor);
- ``fit``: the unwrapped ``ExistingDataSetIterator`` (gather and copy in
  the training thread);
- ``async``: ``AsyncDataSetIterator(queueSize 4)`` over the native ring;
- ``async_python``: the same over the Python ring (``forcePython``);
- ``async_views``: the native ring over the 9 batches built beforehand
  (the producer packs and pushes, no gather);
- ``async_switch_0.5ms``: ``async`` with the interpreter's switch
  interval at 0.5 ms (restored after): how much the GIL's 5 ms handoff
  costs the training thread;
- ``async_prefilled``: the native ring holding all 9 batches before
  ``fit`` starts (queueSize 9, the producer done): the training thread's
  pop and stage alone, with no producer running beside the steps;
- ``async_cpu``: the native ring with ``device="cpu"``: the batches come
  out as numpy views of the popped bytes and ``fit`` copies them to the
  card itself (no pinned buffers, no side stream).

Through ``fitDataSet(stepsPerSync=4)``, whose ``BlockStager`` pins each
block's stack and copies it on a side stream:

- ``fds``: the unwrapped iterator;
- ``fds_async``: the native ring handing its batches to the card through
  pinned buffers (the stager stacks them there);
- ``fds_async_cpu``: the native ring's numpy views (``device="cpu"``),
  stacked, pinned and copied by the stager.

Prints each variant's ms a step (host wall of 9 steps / 9, the smoke's
method), and for the ring variants the median of each prefetch span
(the producer's next, pack and push; the training thread's pop and
stage), then one line ``PREFETCH_AB {json}`` with the card's name and
power limit.

    python3 scripts/prefetch_ab.py       # from the root of a checkout

Needs a CUDA card; exits 2 without one.
"""

import json
import os
import subprocess
import sys
import time


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("prefetch_ab: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.data import (
        DataSet, ExistingDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn import Nesterovs
    from deeplearning4j_tpu_torch.runtime import (
        AsyncDataSetIterator, telemetry,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda")
    B = cs.RESNET_TIMED["batch"]
    nb = cs.RUNTIME_RESNET["batches"]
    x, y = cs.runtime_images(np.random.RandomState(cs.SEED + 14), nb * B)
    batches = [DataSet(x[i * B:(i + 1) * B], y[i * B:(i + 1) * B])
               for i in range(nb)]
    resident = [DataSet(torch.from_numpy(d.getFeatures()).to(dev),
                        torch.from_numpy(d.getLabels()).to(dev))
                for d in batches]

    class Batches:
        """The given DataSets, in order, as they are."""

        def __init__(self, items):
            self.items, self.i = items, 0

        def reset(self):
            self.i = 0

        def hasNext(self):
            return self.i < len(self.items)

        def next(self):
            self.i += 1
            return self.items[self.i - 1]

    class Prefilled:
        """An async iterator whose producer has packed every batch
        before the first step: fit's reset() does not restart it."""

        def __init__(self):
            self.it = AsyncDataSetIterator(
                ExistingDataSetIterator(DataSet(x, y), B), queueSize=nb,
                device=dev)
            while self.it.ring.count() < nb:
                time.sleep(0.01)

        def reset(self):
            pass

        def hasNext(self):
            return self.it.hasNext()

        def next(self):
            return self.it.next()

        def close(self):
            self.it.close()

    def source(name):
        if name == "async_prefilled":
            return Prefilled()
        if name == "resident":
            return Batches(resident)
        if name in ("fit", "fds"):
            return ExistingDataSetIterator(DataSet(x, y), B)
        if name == "async_views":
            return AsyncDataSetIterator(Batches(batches), queueSize=4,
                                        device=dev)
        return AsyncDataSetIterator(
            ExistingDataSetIterator(DataSet(x, y), B), queueSize=4,
            forcePython=name == "async_python",
            device="cpu" if name.endswith("_cpu") else dev)

    start = cs.resnet_net(dev, cs.RESNET_TIMED, "BFLOAT16",
                          dataFormat="NHWC", updater=Nesterovs(0.1, 0.9))
    start.fit(batches[0])                 # warm up off the clock
    reg = telemetry.get_registry()
    names = ["resident", "fit", "async", "async_python", "async_views",
             "async_switch_0.5ms", "async_prefilled", "async_cpu", "fds",
             "fds_async", "fds_async_cpu"]
    ms = {n: [] for n in names}
    spans = {}
    for order in (names, names[::-1]):
        for name in order:
            net = start.clone()
            it = source(name)
            was = sys.getswitchinterval()
            if name.endswith("0.5ms"):
                sys.setswitchinterval(0.0005)
            if name != "async_prefilled":
                reg.trace.clear()
            try:
                torch.cuda.synchronize()
                t = time.perf_counter()
                if name.startswith("fds"):
                    net.fitDataSet(it, stepsPerSync=4)
                else:
                    net.fit(it)
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t) * 1e3 / nb)
            finally:
                sys.setswitchinterval(was)
            if hasattr(it, "close"):
                it.close()
                spans[name] = cs.prefetch_spans(reg)
            del net, it
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    out = {"ms_per_step": ms, "prefetch_spans_median_ms": spans,
           "card": card}
    for name in names:
        print(f"{name}: {' / '.join(f'{v:.2f}' for v in ms[name])} ms a "
              "step" + (f"; spans {spans[name]}" if name in spans else ""))
    print("PREFETCH_AB " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
