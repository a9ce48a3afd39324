#!/usr/bin/env python3
"""Time the host-bound training steps of the checkout in the working
directory with chip_smoke.py's own functions and configurations: phase
8(b) (zoo LeNet, f32, batch 64, images/s), 9(b) (zoo ResNet50, bf16 NHWC,
batch 128, median step ms), 12(b) (the GravesLSTM char-RNN, median fit
ms) and 11(a) (the SameDiff MLP, fit steps/s: a path the networks' code
does not reach, so it shows how much the host alone moves).

    cd <checkout> && python3 <this file>

To compare two checkouts on one card, run it from the root of each in
turns (older, newer, newer, older) in one call. Prints one line per
checkout: ``AB <cwd> {json}``. Needs a CUDA card; exits 2 without one.
"""

import json
import os
import sys


def main():
    import torch

    if not torch.cuda.is_available():
        print("host_ab: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"lenet_images_per_s":
           cs.lenet_and_check(dev, cs.LENET)["images_per_s"]}
    net, x, y, timed = cs.resnet_timed(dev, cs.RESNET_TIMED)
    out["resnet_step_ms"] = timed["step_ms_median_3_on"]
    del net, x, y
    torch.cuda.empty_cache()
    net, train = cs.char_rnn_train(dev, cs.CHAR_RNN)
    out["char_rnn_fit_ms"] = train["fit_ms_median_3_to_20"]
    del net
    out["sd_mlp_fit_steps_per_s"] = cs.samediff_mlp(
        dev, cs.SD_MLP)["fit_steps_per_s"]
    print("AB", os.getcwd(), json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
