#!/usr/bin/env python3
"""Time the paged kernels K4 and K5 of the checkout in the working
directory, the way chip_smoke.py beside this script times them.

    cd <checkout> && python3 <this checkout>/scripts/paged_ab.py

``deeplearning4j_tpu_torch`` is imported from the working directory, so
an older checkout's kernels can be timed by this checkout's method; run
two checkouts in turns in one call (older, newer, newer, older) to
compare them on one card. Inputs are phase 3's shapes in bf16, then
f32, from seed 0 (H 12, Dh 64, page 16, MP 64, 513 pool pages): K4 at
the S 8 batch (lengths 0, 1, 16, 17, 1024, 300, 511, 64) and at S 1
length 1024, K5 at t0 496 (9 rows) and 1008 (16 rows). Each row holds
the kernel's, the plain version's and gather +
scaled_dot_product_attention's ms, the bound and the max abs error
against the plain version; the host µs per call of K4 S 8 and K5 t0
496 issued back to back; K4 and K5 in bf16 over 24 input seeds
(``chip_smoke.seed_sweep``: the largest ulp distance to the plain
version and how much further from an f64 answer than the plain version
the kernel lands); and one bucket-8
``decode_paged`` step of GPT-2-small widths timed as phase 4 times it
(host and device ms). Prints the card's name and power limit, then one
JSON line.
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


def host_us_per_call(fn, calls=200):
    """Host µs per call of `fn`, issued back to back without a
    synchronize: the wrapper's and the launches' host cost (few enough
    calls that the launch queue never fills)."""
    import time

    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main():
    import torch

    if not torch.cuda.is_available():
        print("paged_ab: no CUDA device visible", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from deeplearning4j_tpu_torch.ops import paged_attention as tpa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    H, DH, PAGE, MP, P = smoke.H, smoke.DH, smoke.PAGE, smoke.MP, smoke.P
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    rows, host_us = {}, {}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        rng = np.random.default_rng(smoke.SEED)

        def randn(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev, dtype)

        kp, vp = randn(P, PAGE, H, DH), randn(P, PAGE, H, DH)
        for lens in ([0, 1, 16, 17, 1024, 300, 511, 64], [MP * PAGE]):
            bt = torch.from_numpy(smoke.tables(rng, lens)).to(dev)
            sl = torch.tensor(lens, dtype=torch.int32, device=dev)
            q = randn(len(lens), H, DH)
            err = float((tpa.paged_flash_decode(q, kp, vp, bt, sl).float()
                         - tpa.paged_decode_plain(q, kp, vp, bt, sl)
                         .float()).abs().max())
            rows[f"{name} decode S{len(lens)}"] = smoke.decode_timing(
                tpa, q, kp, vp, bt, sl, lens, err, flush)
            if name == "bf16" and len(lens) == 8:
                host_us["K4 S8"] = host_us_per_call(
                    lambda: tpa.paged_flash_decode(q, kp, vp, bt, sl))
        bt1 = torch.from_numpy(smoke.tables(rng, [MP * PAGE])[0]).to(dev)
        for t0, n in ((496, 9), (MP * PAGE - PAGE, PAGE)):
            qc = randn(PAGE, H, DH)
            err = float((tpa.paged_flash_prefill(qc, kp, vp, bt1, t0, n)[:n]
                         .float() - tpa.paged_prefill_plain(
                             qc, kp, vp, bt1, t0, n)[:n].float())
                        .abs().max())
            rows[f"{name} prefill t0 {t0}"] = smoke.prefill_timing(
                tpa, qc, kp, vp, bt1, t0, n, err, flush)
            if name == "bf16" and t0 == 496:
                host_us["K5 t0 496"] = host_us_per_call(
                    lambda: tpa.paged_flash_prefill(qc, kp, vp, bt1, t0, n))
    sweep = smoke.seed_sweep(tpa, dev, torch.bfloat16)
    from deeplearning4j_tpu_torch.nn.transformer import CausalTransformerLM
    lm = CausalTransformerLM(device=dev, **smoke.GPT2_SMALL)
    burst = np.random.default_rng(smoke.SEED).integers(
        64, min(513, lm.max_context - 31), size=8)
    step = smoke.time_decode_step(lm, dev, [int(n) + 16 for n in burst])
    print(card)
    print(json.dumps({"tree": os.getcwd(), "rows": rows,
                      "host_us_per_call": host_us, "decode_step": step,
                      "bf16_seeds": sweep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
