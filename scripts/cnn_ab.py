#!/usr/bin/env python3
"""Time the CNN training steps of the checkout in the working directory:
chip_smoke.py phase 8(b) (zoo LeNet, f32, batch 64, a DataSetIterator
fit) and phase 9(b) (zoo ResNet50, bf16 NHWC, batch 128, 224x224,
Nesterovs), with the smoke's own functions and configurations.

    cd <checkout> && python3 <this file>

To compare two checkouts on one card, run it from the root of each in
turns (older, newer, newer, older) in one call: two calls may land on
cards and hosts that differ. Prints one line per checkout:
``AB <cwd> resnet_ms <median of steps 3-20> images_per_s <..> lenet_ms
<median of steps 3-20>``. Needs a CUDA card; exits 2 without one.
"""

import os
import sys


def main():
    import torch

    if not torch.cuda.is_available():
        print("cnn_ab: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    lenet = cs.lenet_and_check(dev, cs.LENET)
    resnet = cs.resnet_timed(dev, cs.RESNET_TIMED)[3]
    print("AB", os.getcwd(), "resnet_ms", resnet["step_ms_median_3_on"],
          "images_per_s", resnet["images_per_s"], "lenet_ms",
          lenet["step_ms_median_3_on"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
