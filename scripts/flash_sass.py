#!/usr/bin/env python3
"""What nvcc makes of the flash attention kernels (K1-K3).

    python3 scripts/flash_sass.py [--sass DIR]   # from a checkout's root

Compiles deeplearning4j_tpu_torch/csrc/flash_attention.cu for sm_90a with
the flags ops/_kernels.py uses, into a cubin in a temporary directory,
with ``-Xptxas -v``; then disassembles it with ``cuobjdump -sass``. For
every kernel instantiation (K1-K3, f32 and bf16, each padded head width)
it prints the registers and spill bytes ptxas reports, the count of each
instruction class that matters here: ``HMMA.1688.F32.TF32`` (mma.sync
m16n8k8 with TF32 operands), FFMA (fp32 FMAs on the CUDA cores), LDGSTS
(cp.async copies) and LDS (shared-memory loads), and the 12 commonest
base opcodes; then one JSON line of the same. Counts are of the
compiled code, not of executed instructions: a loop body counts once.
``--sass DIR`` also writes each kernel's SASS to DIR/<kernel>.sass.

It then checks what the kernels' design promises and exits 1 if it
does not hold: every instantiation of K1, K2 and K3 takes its products
on the tensor cores (``HMMA.1688.F32.TF32`` present), and K1 spills
nothing at DP 64 (its KV loop) in f32 or bf16. FFMA is left in the
exp, the rescale and the scale only; that is read from the SASS, not
checked here. Needs the CUDA toolkit (CUDA_HOME or /usr/local/cuda).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "deeplearning4j_tpu_torch" / "csrc" / "flash_attention.cu"
CLASSES = ("HMMA.1688.F32.TF32", "FFMA", "LDGSTS", "LDS")


def kernel_name(mangled):
    """flash_bwd_dq_kernel<float, 64> style name of a mangled symbol."""
    m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(\w+?)Li(\d+)E",
                  mangled)
    if not m:
        return mangled
    dtype = {"f": "float", "13__nv_bfloat16": "bf16"}.get(m.group(2),
                                                           m.group(2))
    return f"{m.group(1)}<{dtype}, {m.group(3)}>"


def expectations(kernels):
    """The design's promises that do not hold in `kernels`, as text."""
    bad = []
    for name, k in sorted(kernels.items()):
        if name.startswith("flash_") and not k.get(CLASSES[0]):
            bad.append(f"{name}: no {CLASSES[0]}: products off the tensor "
                       "cores")
    for dtype in ("float", "bf16"):
        k = kernels.get(f"flash_fwd_kernel<{dtype}, 64>", {})
        if k.get("spill_store_bytes", 0) or k.get("spill_load_bytes", 0):
            bad.append(f"flash_fwd_kernel<{dtype}, 64> spills")
    return bad


def main():
    sass_dir = None
    if sys.argv[1:2] == ["--sass"] and len(sys.argv) > 2:
        sass_dir = Path(sys.argv[2])
        sass_dir.mkdir(parents=True, exist_ok=True)
    cuda = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    nvcc, cuobjdump = cuda / "bin" / "nvcc", cuda / "bin" / "cuobjdump"
    if not nvcc.exists():
        print(f"flash_sass: no nvcc at {nvcc}", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "flash_attention.cubin"
        res = subprocess.run(
            [str(nvcc), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v", "-o",
             str(cubin), str(SRC)], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-6000:], file=sys.stderr)
            return 1
        sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)],
                              capture_output=True, text=True, check=True
                              ).stdout
    kernels = {}
    name = None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
            kernels[name] = {}
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            kernels[name]["spill_store_bytes"] = int(m.group(1))
            kernels[name]["spill_load_bytes"] = int(m.group(2))
    name = None
    text = {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            kernels.setdefault(name, {})
            kernels[name].update({c: 0 for c in CLASSES})
            continue
        if name is None:
            continue
        text.setdefault(name, []).append(line)
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                      line)
        if not m:
            continue
        op = m.group(1)
        for c in CLASSES:
            if op == c or op.startswith(c + "."):
                kernels[name][c] += 1
        base = op.split(".")[0]
        ops = kernels[name].setdefault("opcodes", {})
        ops[base] = ops.get(base, 0) + 1
    for k in kernels.values():   # the 12 commonest base opcodes
        ops = k.get("opcodes", {})
        k["opcodes"] = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12])
    if sass_dir is not None:
        for k, lines in text.items():
            fname = re.sub(r"[^\w]+", "_", k).strip("_") + ".sass"
            (sass_dir / fname).write_text("\n".join(lines) + "\n")
    for k in sorted(kernels):
        print(k, json.dumps(kernels[k]))
    bad = expectations(kernels)
    for b in bad:
        print(f"flash_sass: {b}", file=sys.stderr)
    print(json.dumps({"source": str(SRC.relative_to(ROOT)),
                      "kernels": kernels, "expectations_met": not bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
