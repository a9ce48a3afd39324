#!/usr/bin/env python3
"""Measure cuDNN's convolution workspaces on the card, and PAR06's
prediction (``analysis/partitioning.py``) against a small CNN's peak
under each cuDNN setting.

Every convolution the given networks' train steps make is recorded from
PAR06's own meta run; each distinct call (the aten op, its shapes,
strides and dtype) is then run on the card, alone, under each cuDNN
setting, and its workspace is read from the caching allocator: the peak
over the call less what it leaves allocated (its outputs), the larger of
a first and a second call. A row per call and setting goes to
``chiprun_out/conv_workspace.jsonl``. The summary line gives, per
precision regime (bf16, f32 with TF32, f32 without), the largest
workspace and its largest ratio to the call's input plus output bytes.

Then the eager peak of SimpleCNN b64 at 64² (the card test's network)
over 3 fit steps is measured under each setting beside PAR06's
prediction.

    python3 scripts/conv_workspace.py            # every case
    python3 scripts/conv_workspace.py simplecnn  # the named cases
    python3 scripts/conv_workspace.py --decides  # SimpleCNN under a cap

``--decides`` asks whether a workspace decides a fit or only raises the
peak: SimpleCNN b64 (TF32 off, deterministic) runs with the caching
allocator capped at its tensors' predicted bytes plus 5 %.

Exits 2 without a CUDA card.
"""

import gc
import json
import os
import sys
import time

#: (case, zoo model, input (C, H, W), batch, dtype, data format)
CASES = {
    "simplecnn": ("SimpleCNN", (3, 64, 64), 64, "FLOAT", "NCHW"),
    "resnet50": ("ResNet50", (3, 224, 224), 128, "BFLOAT16", "NHWC"),
    "yolo2": ("YOLO2", (3, 416, 416), 16, "BFLOAT16", "NHWC"),
    "lenet": ("LeNet", (1, 28, 28), 64, "FLOAT", "NCHW"),
    "vgg16": ("VGG16", (3, 224, 224), 32, "FLOAT", "NCHW"),
    "alexnet": ("AlexNet", (3, 224, 224), 32, "FLOAT", "NCHW"),
    "darknet19": ("Darknet19", (3, 224, 224), 32, "BFLOAT16", "NHWC"),
    "unet": ("UNet", (3, 128, 128), 8, "FLOAT", "NCHW"),
}
#: (cudnn.deterministic, cudnn.allow_tf32): PyTorch's defaults, the
#: smoke's and the card tests', and the two others
SETTINGS = ((False, True), (True, False), (False, False), (True, True))


def conf_of(case):
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.nn import DataType

    name, shape, batch, dtype, fmt = CASES[case]
    kw = dict(inputShape=shape, dataType=getattr(DataType, dtype),
              dataFormat=fmt)
    if name in ("SimpleCNN", "LeNet", "VGG16", "AlexNet", "Darknet19"):
        kw["numClasses"] = 10
    return getattr(zoo, name)(**kw).conf(), batch


def geometry(op, args):
    """Bytes in and out of one convolution call (forward: input and
    output; backward: the input and the gradient of the output)."""
    x, w = (args[1], args[2]) if op == "convolution_backward" \
        else (args[0], args[1])
    stride, pad, dil, transposed, opad, groups = \
        args[4:10] if op == "convolution_backward" else args[3:9]
    es = x.element_size()
    sp, k = list(x.shape[2:]), list(w.shape[2:])
    K = w.shape[1] * groups if transposed else w.shape[0]
    if transposed:
        osp = [(i - 1) * s - 2 * p + d * (kk - 1) + o + 1 for i, s, p, d,
               kk, o in zip(sp, stride, pad, dil, k, opad)]
    else:
        osp = [(i + 2 * p - d * (kk - 1) - 1) // s + 1 for i, s, p, d, kk
               in zip(sp, stride, pad, dil, k)]
    n_in = x.shape[0] * x.shape[1]
    n_out = x.shape[0] * K
    for i in sp:
        n_in *= i
    for o in osp:
        n_out *= o
    return {"in_bytes": int(n_in) * es, "out_bytes": int(n_out) * es}


def record_calls(case):
    """The step's convolution calls, from PAR06's meta run."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from deeplearning4j_tpu_torch.analysis import partitioning as part

    ops = {torch.ops.aten.convolution.default: "convolution",
           torch.ops.aten.convolution_backward.default:
               "convolution_backward"}

    def spec(a):
        if isinstance(a, torch.Tensor):
            return (tuple(a.shape), tuple(a.stride()),
                    str(a.dtype).replace("torch.", ""))
        return a

    calls = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in ops:
                calls.append({
                    "op": ops[func], "args": [spec(a) for a in args],
                    "dtype": str(args[1].dtype).replace("torch.", ""),
                    "features": geometry(ops[func], args)})
            return func(*args, **(kwargs or {}))

    conf, batch = conf_of(case)
    with Spy():
        part.step_high_water(conf, batch)
    return calls


def _tensor(spec, dev, gen):
    import torch

    size, stride, dtype = spec
    need = 1 + sum((s - 1) * st for s, st in zip(size, stride)) \
        if all(size) else 0
    base = torch.randn(max(need, 1), generator=gen, device=dev,
                       dtype=torch.float32).to(getattr(torch, dtype))
    return base.as_strided(size, stride)


def run_call(call, dev, gen):
    """The call's workspace on the card (bytes): the peak over it less
    what it leaves allocated, the larger of two runs."""
    import torch

    args = [_tensor(a, dev, gen) if isinstance(a, tuple) and len(a) == 3
            and isinstance(a[2], str) else a for a in call["args"]]
    op = getattr(torch.ops.aten, call["op"]).default
    worst = 0
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        with torch.no_grad():
            out = op(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        kept = torch.cuda.memory_allocated(dev) - base
        worst = max(worst, peak - base - kept)
        del out
    return worst


def simplecnn_peak(dev, B=64):
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.zoo import SimpleCNN

    w = torch.ones(8, 8, device=dev, requires_grad=True)
    (w @ w).sum().backward()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    net = SimpleCNN(numClasses=10, inputShape=(3, 64, 64),
                    device=dev).init()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((B, 3, 64, 64),
                                    dtype=np.float32)).to(dev)
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, B)]).to(dev)
    for _ in range(3):
        net.fit(x, y)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    del net, x, y
    return peak


def workspace_decides(dev, B=64, steps=3):
    """Does a convolution workspace decide a fit, or only raise the peak?
    SimpleCNN b`B` f32 at 64², TF32 off, deterministic: PAR06's
    prediction without the workspace term (TF32 on: no term) and with it;
    then `steps` fit steps with the caching allocator capped (this
    process only, ``set_per_process_memory_fraction``) at what it holds
    now plus the tensor-only prediction plus 5 %: cuDNN must run in the
    room the tensors leave. Returns the predictions, the cap, whether the
    steps ran, their peak and median step ms beside an uncapped run."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.analysis.partitioning import \
        step_high_water
    from deeplearning4j_tpu_torch.zoo import SimpleCNN

    conf = SimpleCNN(numClasses=10, inputShape=(3, 64, 64)).conf()
    torch.backends.cudnn.allow_tf32 = True
    p0 = step_high_water(conf, B)["total_bytes"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    p1 = step_high_water(conf, B)["total_bytes"]

    def run():
        net = SimpleCNN(numClasses=10, inputShape=(3, 64, 64),
                        device=dev).init()
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.random((B, 3, 64, 64),
                                        dtype=np.float32)).to(dev)
        y = torch.from_numpy(np.eye(10, dtype=np.float32)[
            rng.integers(0, 10, B)]).to(dev)
        ms = []
        for _ in range(steps):
            t = time.perf_counter()
            net.fit(x, y)
            net.score()
            ms.append((time.perf_counter() - t) * 1e3)
        return float(np.median(ms))

    out = {"batch": B, "tensor_prediction": p0, "with_workspace": p1}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out["step_ms_free"] = run()
    out["peak_free"] = torch.cuda.max_memory_allocated(dev) - base
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(dev).total_memory
    cap = torch.cuda.memory_reserved(dev) + int(1.05 * p0)
    out["cap_bytes_over_held"] = int(1.05 * p0)
    idx = torch.cuda.current_device()
    torch.cuda.set_per_process_memory_fraction(cap / total, idx)
    try:
        # the control first: TF32 on (small workspaces) under the same cap
        for name, tf32 in (("control_tf32", True), ("capped", False)):
            torch.backends.cudnn.allow_tf32 = tf32
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            try:
                out[f"step_ms_{name}"] = run()
                out[f"fit_{name}"] = True
                out[f"peak_{name}"] = \
                    torch.cuda.max_memory_allocated(dev) - base
            except torch.OutOfMemoryError as e:
                out[f"fit_{name}"] = False
                out[f"error_{name}"] = str(e).splitlines()[0][:300]
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_per_process_memory_fraction(1.0, idx)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def regime(row):
    if row["dtype"] != "float32":
        return row["dtype"]
    return "float32, tf32" if row["tf32"] else "float32, no tf32"


def main(which):
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("conv_workspace: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from deeplearning4j_tpu_torch.analysis import validate_plan

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if which == ["--decides"]:
        print(json.dumps({"card": card,
                          "decides": workspace_decides(dev)}))
        return 0
    gen = torch.Generator(device=dev).manual_seed(0)
    os.makedirs("chiprun_out", exist_ok=True)
    rows, seen = [], set()
    t = time.perf_counter()
    for case in which:
        for call in record_calls(case):
            key = json.dumps([call["op"], call["args"]])
            if key in seen:
                continue
            seen.add(key)
            for det, tf32 in SETTINGS:
                if call["dtype"] != "float32" and tf32:
                    continue
                torch.backends.cudnn.deterministic = det
                torch.backends.cudnn.allow_tf32 = tf32
                rows.append({"case": case, "op": call["op"],
                             "args": call["args"], "dtype": call["dtype"],
                             "deterministic": det, "tf32": tf32,
                             "measured": run_call(call, dev, gen),
                             "features": call["features"]})
                gc.collect()
                torch.cuda.empty_cache()
    with open("chiprun_out/conv_workspace.jsonl", "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    summary = {"card": card, "calls": len(seen), "rows": len(rows),
               "seconds": time.perf_counter() - t, "regimes": {}}
    for name in sorted({regime(r) for r in rows}):
        sel = [r for r in rows if regime(r) == name]
        summary["regimes"][name] = {
            "max_workspace": max(r["measured"] for r in sel),
            "max_per_io_byte": max(
                r["measured"] / (r["features"]["in_bytes"]
                                 + r["features"]["out_bytes"])
                for r in sel)}
    if "simplecnn" in which:
        conf, batch = conf_of("simplecnn")
        pred = validate_plan(conf, {"data": 1}, batchSize=batch
                             ).plan["memory"]
        peaks = {}
        for det, tf32 in SETTINGS:
            torch.backends.cudnn.deterministic = det
            torch.backends.cudnn.allow_tf32 = tf32
            peaks[f"det={det},tf32={tf32}"] = simplecnn_peak(dev)
            gc.collect()
            torch.cuda.empty_cache()
        summary["simplecnn_b64"] = {
            "predicted": pred["total_bytes"], "measured": peaks,
            "ratio": {k: pred["total_bytes"] / v for k, v in peaks.items()}}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(CASES)))
