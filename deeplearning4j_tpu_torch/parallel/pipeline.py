"""Pipeline-stage partitioning (reference:
``deeplearning4j_tpu/parallel/pipeline.py``).

Ported: the pure planning functions the partition-plan analyzer
(``analysis.partitioning``, PAR05) needs and ROADMAP Queue 1 item 7 will
execute: ``partition_stages`` (the reference's balance rule, :91 there:
the longest run of structurally identical layers, trimmed to a multiple
of the stage count, with shape-changing layers kept out of it),
``stage_input_sizes`` and ``layer_signature``. A parameter here is
anything with a ``.shape`` (a tensor, a meta tensor).

The executing trainer (``PipelineParallel``: a GPipe schedule over a
pipe axis) waits for ROADMAP Queue 1 item 7 and raises naming it.
"""

from __future__ import annotations

__all__ = ["PipelineParallel", "layer_signature", "partition_stages",
           "stage_input_sizes"]


def _cfg_repr(v):
    """Value-based repr for config objects: two separately-constructed
    Dropout(0.5) instances must compare equal."""
    if v is None or isinstance(v, (int, float, str, bool)):
        return v
    try:
        return (type(v).__name__,
                tuple(sorted((k, _cfg_repr(x)) for k, x in vars(v).items())))
    except TypeError:
        return type(v).__name__


def layer_signature(layer, params):
    """Stages must match on this: type, parameter shapes and the
    behavioural config (activation, dropout, updater)."""
    return (type(layer).__name__,
            str(getattr(layer, "activation", None)),
            _cfg_repr(getattr(layer, "dropOut", None)),
            _cfg_repr(getattr(layer, "updater", None)),
            tuple(sorted((k, tuple(v.shape)) for k, v in params.items())))


def stage_input_sizes(conf):
    """Per-layer boundary feature sizes for ``partition_stages``'
    `input_sizes` (index len(layers) = network output), read from the
    config's recorded layerInputTypes; None when the config carries no
    per-layer types (an unbuilt builder)."""
    def size_of(it):
        try:
            return it.size
        except Exception:
            return None

    sizes = [size_of(it)
             for it in getattr(conf, "layerInputTypes", [])] + [None]
    if len(sizes) != len(conf.layers) + 1:
        return None
    return sizes


def partition_stages(layers, params, n_stages, input_sizes=None):
    """Split a layer list into (prologue_idx, body_idx, epilogue_idx):
    body is the longest run of identical-signature layers, trimmed to a
    multiple of n_stages. With `input_sizes`, run members must also keep
    the boundary size (in == out), so a shape-changing entry layer stays
    in the prologue. Raises ValueError if no run is long enough."""
    sigs = [layer_signature(l, p) for l, p in zip(layers, params)]
    if input_sizes is not None:
        for i in range(len(sigs)):
            nxt = input_sizes[i + 1] if i + 1 < len(input_sizes) else None
            if input_sizes[i] is None or nxt is None or input_sizes[i] != nxt:
                sigs[i] = ("__boundary_changing__", i)
    best_start, best_len = 0, 0
    i = 0
    while i < len(sigs):
        j = i
        while j < len(sigs) and sigs[j] == sigs[i]:
            j += 1
        if j - i > best_len and not (isinstance(sigs[i][0], str)
                                     and sigs[i][0] == "__boundary_changing__"):
            best_start, best_len = i, j - i
        i = j
    if best_len < n_stages:
        raise ValueError(
            f"Pipeline needs >= {n_stages} structurally identical "
            f"consecutive layers; longest homogeneous run is {best_len}. "
            "Pipeline parallelism targets repeated-block architectures "
            "(transformer/MLP stacks).")
    use = (best_len // n_stages) * n_stages
    # the TRAILING `use` layers of the run form the body, so a
    # shape-changing first instance stays in the prologue
    body_start = best_start + (best_len - use)
    body_end = body_start + use
    return (list(range(0, body_start)),
            list(range(body_start, body_end)),
            list(range(body_end, len(layers))))


class PipelineParallel:
    """The GPipe trainer over a pipe axis (reference:
    ``PipelineParallel``): waits for ROADMAP Queue 1 item 7."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PipelineParallel waits for the rest of the data-parallel "
            "slice (ROADMAP.md Queue 1 item 7): the port executes the "
            "data axis only; analysis.validate_plan checks pipe plans "
            "statically")
