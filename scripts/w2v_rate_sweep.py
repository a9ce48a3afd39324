#!/usr/bin/env python3
"""The learning rate of chip_smoke.py phase 21(a)'s CBOW fit.

The port's Word2Vec step is the reference's: the gradient of the
batch's MEAN loss at a constant rate, so word2vec.c's per-pair rate
(0.05) is no guide at batch 1024. This fits CBOW at word2vec.c's
demo-word.sh text8 widths (200-d, window 8, negative 25, batch 1024,
one epoch) over phase 21's synthetic corpus at each rate given (default
1, 4, 10, 20, 50 and 0.025), one vocabulary scan shared through
``vocabCache``, and prints one JSON line a rate: the fit's seconds and
steps, the first and last batch's loss, the mean row norm of W and the
share of twenty probe words' 10 nearest words in their topic.

    python3 scripts/w2v_rate_sweep.py [rate ...]   # from the repo root
"""

import json
import os
import sys
import time


def main(argv):
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.nlp import (CollectionSentenceIterator,
                                              Word2Vec)

    torch.backends.cuda.matmul.allow_tf32 = False
    rates = [float(a) for a in argv] or [1.0, 4.0, 10.0, 20.0, 50.0, 0.025]
    t = time.perf_counter()
    sents, topic, counts = cs.synthetic_text8(cs.TEXT8)
    print(json.dumps({"sentences": len(sents), "tokens": int(counts.sum()),
                      "seconds": time.perf_counter() - t}), flush=True)
    cfg = cs.W2V_TEXT8
    probes = [f"w{r}" for r in range(*cfg["probe_ranks"])]
    base = None
    for lr in rates:
        b = (Word2Vec.Builder().minWordFrequency(cs.TEXT8["min_count"])
             .layerSize(cfg["layer"]).windowSize(cfg["window"])
             .negativeSample(cfg["negative"]).batchSize(cfg["batch"])
             .learningRate(lr).elementsLearningAlgorithm("cbow")
             .iterate(CollectionSentenceIterator(sents)))
        if base is not None:
            b.vocabCache(base)
        m = b.build()
        t = time.perf_counter()
        m.fit()
        torch.cuda.synchronize()
        base = base or m
        share, each = cs.topic_share(m, topic, probes)
        print(json.dumps({
            "lr": lr, "fit_s": time.perf_counter() - t,
            "train_s": m.trainLog.seconds, "steps": m.stepsTaken,
            "loss_first": m.trainLog.first, "loss_last": m.trainLog.last,
            "w_row_norm": float(m._W.norm(dim=1).mean()),
            "topic_share": share, "each": each}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
