#!/usr/bin/env python3
"""Time chip_smoke.py phase 13(a)'s data-parallel modes of the checkout
in the working directory, beside phase 9(b)'s plain step.

    (cd <checkout> && python3 <this repo>/scripts/dp_ab.py [steps])

Runs phase 9(b) (zoo ResNet50, bf16 NHWC, batch 128, Nesterovs) for its
20 steps, then on a world-1 NCCL process group SharedTrainingMaster in
each of phase 13's modes for `steps` steps (default 20) on the same
batch, and prints one JSON line: each mode's median step ms of steps 3
on, the ratio to phase 9(b)'s median, and the card's name and power
limit. Run two checkouts in turns in one call (A, B, B, A) to compare
them on one card.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())


def main():
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.parallel import initializeMultiHost

    if not torch.cuda.is_available():
        print("dp_ab: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    dev = torch.device("cuda")
    net, x, y, plain = cs.resnet_timed(dev, cs.RESNET_TIMED)
    del net
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="dp_ab_")
    group = initializeMultiHost(init_method=f"file://{tmp}/store",
                                num_processes=1, process_id=0, device=dev)
    out = {"checkout": os.getcwd(),
           "plain_step_ms": plain["step_ms_median_3_on"]}
    try:
        cfg = dict(cs.RESNET_TIMED, steps=steps)
        for mode in cs.DP_MODES:
            r = cs.dp_train(dev, cfg, group, x, y, mode,
                            plain_ms=plain["step_ms_median_3_on"],
                            check=False)
            out[r["mode"]] = {"step_ms": r["step_ms_median_3_on"],
                              "over_plain": r["step_over_phase9b"]}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
