#!/usr/bin/env python3
"""Which embedding lookup has a bitwise-repeatable backward on the card:
``F.embedding``, an index (``W[idx]``, what the port's embedding layers
use) and ``index_select``, each run 7 times on the same inputs, with and
without ``torch.use_deterministic_algorithms``, at index distributions
from every row repeated ~1,000 times to nearly unique rows; then, for
the sequence classifier's head, whether any product form of a per-step
output layer equals a dense head on the gathered last step bit for bit.

    python3 scripts/embedding_det.py

Prints one line per case. Needs a CUDA card; exits 2 without one.
"""

import sys

import torch
import torch.nn.functional as F


def grads(method, W, idx, g):
    Wl = W.detach().requires_grad_(True)
    if method == "F.embedding":
        y = F.embedding(idx, Wl)
    elif method == "advanced_index":
        y = Wl[idx]
    else:
        y = Wl.index_select(0, idx.reshape(-1)).reshape(*idx.shape, -1)
    return torch.autograd.grad(y, Wl, g)[0]


def main():
    if not torch.cuda.is_available():
        print("embedding_det: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for V, D, N, hi in ((300, 64, (64, 256), 16),
                        (20000, 300, (64, 256), 20000),
                        (20000, 300, (64, 256), 400),
                        (300, 64, (8, 200), 16)):
        W = torch.randn(V, D, device=dev, generator=gen)
        idx = torch.randint(0, hi, N, device=dev, generator=gen)
        g = torch.randn(*N, D, device=dev, generator=gen)
        for det in (False, True):
            torch.use_deterministic_algorithms(det, warn_only=True)
            for m in ("F.embedding", "advanced_index", "index_select"):
                ref = grads(m, W, idx, g)
                same = all(torch.equal(ref, grads(m, W, idx, g))
                           for _ in range(6))
                print(f"V {V} D {D} N {N} rows<{hi} deterministic={det} "
                      f"{m}: repeatable {same}")
    torch.use_deterministic_algorithms(False)
    for B, Fd, T, O in ((64, 256, 256, 2), (8, 256, 80, 77)):
        x = torch.randn(B, Fd, T, device=dev, generator=gen)
        W = torch.randn(Fd, O, device=dev, generator=gen) * 0.3
        last = torch.randint(0, T, (B,), device=dev, generator=gen)
        rows = torch.arange(B, device=dev)
        dense = x[rows, :, last] @ W
        for name, y in (("einsum", torch.einsum("bft,fo->bot", x, W)),
                        ("matmul", (x.transpose(1, 2) @ W).transpose(1, 2))):
            got = y[rows, :, last]
            print(f"head B {B} F {Fd} T {T} O {O} {name}: max abs "
                  f"{float((got - dense).abs().max()):.3e}, bitwise "
                  f"{bool(torch.equal(got, dense))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
