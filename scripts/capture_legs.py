#!/usr/bin/env python3
"""Run chip_smoke.py's phases alone, from the root of a checkout: the
capture legs of phase 23 one by one, the phases whose serving paths
replay captured graphs (4-5, 12, 18), the static analysis tier's legs
(24) and the encoder, data-parallel and remat legs (7, 13, 15f), each
with its own pass/fail line.

    python3 scripts/capture_legs.py            # all of phase 23
    python3 scripts/capture_legs.py 23a 23c 4  # the named legs, in order

Legs: 23 (the whole phase), 23a-23e (decode graphs, one-shot buckets,
captured training, autotune, the ledger), 4 (phases 4-5), 12, 18, 24
(the whole phase), 24a-24e (the zoo, PAR06 against the card, validation
bitwise, the chaos soak, collectives), 7 (the encoder, its remat leg
included), 13 (after phase 9(b)'s 20 steps, whose losses it holds dense
to), 15f (the remat A/B), 25 (the mesh axes, after phase 7, whose
losses 25(b) holds) and 26 (distributed linear algebra; 26a its world-1
canonical plans, 26c its consumers, 26b its NCCL legs alone on 4 cards
then on 2, as many as are visible; 26 runs (b) over the cards it sees). TF32 is off, as chip_smoke.py's main sets
it. Exits 1 if a leg failed, 2 without a CUDA card.
"""

import gc
import os
import sys
import time
import traceback


def main(which):
    import torch

    if not torch.cuda.is_available():
        print("capture_legs: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _kernels.library()

    def linalg_nccl():
        """26(b) alone over NCCL: on 4 cards, then on 2 (as many as are
        visible)."""
        from deeplearning4j_tpu_torch.parallel import launch

        for w in (4, 2):
            if torch.cuda.device_count() >= w:
                res = launch(cs.linalg_multi_rank, w, timeout=600,
                             args=(cs.LINALG_MULTI,))
                print(f"26(b) world {w}: {res[0]}", flush=True)

    legs = {
        "23": lambda: cs.capture_phase(dev),
        "23a": lambda: cs.capture_decode(dev, cs.CAPTURE_DECODE),
        "23b": lambda: cs.capture_oneshot(dev),
        "23c": lambda: cs.capture_training(dev, cs.CAPTURE_TRAIN),
        "23d": lambda: cs.capture_autotune(dev, cs.CAPTURE_TUNE),
        "23e": lambda: cs.capture_ledger(dev),
        "4": lambda: cs.serve_and_check(dev, cs.GPT2_SMALL),
        "12": lambda: cs.char_rnn_phase(dev),
        "18": lambda: cs.serving_phase(dev),
        "24": lambda: cs.analysis_phase(dev),
        "24a": lambda: cs.analysis_zoo(dev),
        "24b": lambda: cs.analysis_par06(dev),
        "24c": lambda: cs.analysis_init_bitwise(dev),
        "24d": lambda: cs.analysis_chaos_soak(dev),
        "24e": lambda: cs.analysis_collectives(dev),
        "7": lambda: cs.train_and_check(dev, cs.BERT_BASE),
        "13": lambda: cs.data_parallel_phase(
            dev, cs.RESNET_TIMED, cs.resnet_timed(dev, cs.RESNET_TIMED)[3]),
        "15f": lambda: cs.remat_ab(dev),
        "25": lambda: cs.mesh_axes_phase(
            dev, cs.train_and_check(dev, cs.BERT_BASE)),
        "26": lambda: cs.linalg_phase(dev),
        "26a": lambda: (cs.linalg_gemm(dev, cs.LINALG_GEMM),
                        cs.linalg_tall(dev, cs.LINALG_TALL)),
        "26c": lambda: cs.linalg_consumers(dev, cs.LINALG_CONSUMERS),
        "26b": linalg_nccl,
    }
    ok = True
    for name in which or ["23"]:
        t = time.perf_counter()
        try:
            legs[name]()
            print(f"PHASE {name} OK {time.perf_counter() - t:.1f} s",
                  flush=True)
        except Exception:
            ok = False
            traceback.print_exc()
            print(f"PHASE {name} FAILED {time.perf_counter() - t:.1f} s",
                  flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
