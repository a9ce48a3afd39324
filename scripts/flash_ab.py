#!/usr/bin/env python3
"""Time the flash kernels K1-K3 of the checkout in the working directory,
the way chip_smoke.py beside this script times them (phase 6), and its
training step (phase 7).

    cd <checkout> && python3 <this checkout>/scripts/flash_ab.py [steps]
    cd <checkout> && python3 <this checkout>/scripts/flash_ab.py --k1

``deeplearning4j_tpu_torch`` is imported from the working directory, so
an older checkout's kernels can be timed by this checkout's method; run
two checkouts in turns in one call (older, newer, newer, older) to
compare them on one card. At the training shape (B 8, H 12, T 512, D 64,
non-causal, seed 0 as in phase 6), f32 then bf16: K1, K2, K3 and
flash_bwd whole (delta + K2 + K3), each with its plain version's and
scaled_dot_product_attention's ms (forward for K1, the whole backward
for the others), the bound (f32 at the 3xTF32 rate) and the max abs error
against the plain version; phase 6's f64 gate (8 seeds, B 2, H 12, T
512, D 64, causal and not: the worst excess over the plain version per
tensor); then the BERT-base-width encoder of phase 7 (batch 8 x 512,
f32, Adam, seed 0) fit for `steps` steps (default 8), with the median
host ms of steps 3 onward and the flash kernels' launches per step.
``--k1`` times K1 alone, for comparing its design variants: at the
training shape, f32 and bf16, non-causal and causal, K1 (median of 50)
beside scaled_dot_product_attention's forward (median of 50), its
bound, its max abs error against the plain version and whether its lse
is within rtol/atol 1e-5 of the plain one; then the f64 gate as above.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, os.getcwd())


def k1_rows(smoke, tfa, dev, dtype, flush):
    """K1 at the training shape, non-causal and causal: its ms beside
    SDPA's forward, the bound and its agreement with the plain version."""
    import torch
    import torch.nn.functional as F

    _, B, H, Tq, Tk, D, _ = smoke.FLASH_CASES[0]
    rng = np.random.default_rng(smoke.SEED)
    q, k, v, _ = smoke.flash_inputs(rng, dev, dtype, B, H, Tq, Tk, D)
    rows = {}
    for causal in (False, True):
        o, lse = tfa.flash_fwd(q, k, v, causal, need_lse=True)
        o_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, causal, need_lse=True)
        rows[f"causal {causal}"] = {
            "ms": smoke.time_ms(
                lambda: tfa.flash_fwd(q, k, v, causal, need_lse=True), 50,
                flush),
            "library_ms": smoke.time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal),
                50, flush),
            "bound_ms": smoke.flash_bounds(B, H, Tq, Tk, D, causal,
                                           q.element_size())["K1"][0],
            "max_abs_err": float((o.float() - o_ref.float()).abs().max()),
            "lse_ok": bool(torch.allclose(lse, lse_ref, rtol=1e-5,
                                          atol=1e-5))}
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device visible", file=sys.stderr)
        return 2
    only_k1 = sys.argv[1:2] == ["--k1"]
    steps = int(sys.argv[1]) if len(sys.argv) > 1 and not only_k1 else 8
    spec = importlib.util.spec_from_file_location(
        "smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    _, B, H, Tq, Tk, D, causal = smoke.FLASH_CASES[0]
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    rows, gate = {}, {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        if only_k1:
            for case, r in k1_rows(smoke, tfa, dev, dtype, flush).items():
                rows[f"{name} K1 {case}"] = r
            for c in (False, True):
                gate[f"{name} causal {c}"] = smoke.flash_seed_sweep(
                    tfa, dev, dtype, c)
            continue
        rng = np.random.default_rng(smoke.SEED)
        q, k, v, do = smoke.flash_inputs(rng, dev, dtype, B, H, Tq, Tk, D)
        errs, _, _ = smoke.flash_errors(tfa, q, k, v, do, causal)
        for kname, r in smoke.flash_timing(tfa, q, k, v, do, causal, errs,
                                           flush).items():
            rows[f"{name} {kname}"] = r
        for c in (False, True):
            gate[f"{name} causal {c}"] = smoke.flash_seed_sweep(tfa, dev,
                                                                dtype, c)
        del q, k, v, do
    del flush
    if only_k1:
        print(card)
        print(json.dumps({"tree": os.getcwd(), "rows": rows,
                          "f64_gate": gate}))
        return 0
    cfg = smoke.BERT_BASE
    net = ComputationGraph(smoke.bert_encoder_conf(cfg)).init()
    x, y = smoke.encoder_batch(cfg, dev)
    tfa.reset_launches()
    losses, step_s = smoke.fit_timed(net, x, y, steps)
    train = {"steps": steps,
             "step_ms_median_3_on": float(np.median(step_s[2:])) * 1e3,
             "step_ms_all": [s * 1e3 for s in step_s], "losses": losses,
             "launches_per_step": {
                 "K1": tfa.flash_fwd.launches / steps,
                 "K2": tfa.flash_bwd_dq.launches / steps,
                 "K3": tfa.flash_bwd_dkv.launches / steps}}
    print(card)
    print(json.dumps({"tree": os.getcwd(), "rows": rows, "f64_gate": gate,
                      "train": train}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
