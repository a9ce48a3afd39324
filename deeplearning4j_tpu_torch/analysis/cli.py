"""CLI driver: ``python -m deeplearning4j_tpu_torch.analysis`` (reference:
``deeplearning4j_tpu/analysis/cli.py``; the same subjects and exit
codes, over the port's objects and sources).

Runs the static passes over a model config file, the zoo corpus, or a
source tree:

    python -m deeplearning4j_tpu_torch.analysis --zoo
    python -m deeplearning4j_tpu_torch.analysis model.json
    python -m deeplearning4j_tpu_torch.analysis deeplearning4j_tpu_torch/nn
    python -m deeplearning4j_tpu_torch.analysis --codes
    python -m deeplearning4j_tpu_torch.analysis --parallel --zoo
    python -m deeplearning4j_tpu_torch.analysis --parallel --zoo \\
        --mesh data=4 --hbm-gb 80
    python -m deeplearning4j_tpu_torch.analysis --parallel my_trainer.py

Source paths get the capture-purity lint (PUR01-05). ``--parallel``
switches model subjects to the partition-plan analyzer (PAR01-06:
mesh/spec sanity, divisibility, collective axis consistency, pipeline
balance, the per-card memory fit of the port's own step) on every
``--mesh`` (default: the canonical dp4xtp2 and dp2xpp4 meshes, checked
as plans; the port executes the data axis), and adds the recapture
lint (RTC01-03) and the collective lints (PAR04, COL01) to source
paths.

``--concurrency`` runs the thread-safety lint (THR01-04) and
``--failpaths`` the failure-path lint (FLT01-06) over the given source
paths, defaulting to the port's threaded tier (serving/,
runtime/chaos+telemetry+aot+autotune+resilience+async_iterator,
parallel/inference, util/httpserve+profiler). Pure AST: no imports of
the linted code, no execution.

``--attribution``, ``--precompile`` and ``--autotune`` drive the port's
``analysis/hbm.py`` subjects (lenet, resnet_block) through
``util/hbm_ledger.py`` and ``runtime/autotune.py``; they run the step,
on the card unless ``--device cpu``.

``--linalg`` validates the canonical distributed-linalg block plans
(``linalg/plan.py``: SUMMA GEMM, tall Gram, randomized SVD, CG least
squares) on each ``--mesh`` (default dp4xtp2): PAR01 axes, PAR03
never-pad divisibility, PAR04 the collective lints over the linalg
sources, PAR06 the per-rank bill against ``--hbm-gb`` (default: the
visible card's memory).

Exit status: 0 = clean (warnings allowed), 1 = errors found,
2 = usage / unreadable input.
"""

from __future__ import annotations

import argparse
import json as _json
import sys
import time


def _build_parser():
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.analysis",
        description="Static analysis: config shape/dtype inference, "
                    "partition plans, capture purity, recapture, thread "
                    "and fail-path lints.")
    p.add_argument("paths", nargs="*",
                   help=".json model configs and/or .py files / source "
                        "directories")
    p.add_argument("--zoo", action="store_true",
                   help="validate every zoo model configuration")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable JSON output")
    p.add_argument("--verbose", "-v", action="store_true",
                   help="include the per-layer param/memory table and "
                        "suppressed findings")
    p.add_argument("--codes", action="store_true",
                   help="list every diagnostic code and exit")
    p.add_argument("--batch-size", type=int, default=32,
                   help="batch size assumed by the activation-memory "
                        "report (default 32)")
    p.add_argument("--parallel", action="store_true",
                   help="run the partition-plan analyzer (PAR01-06) on "
                        "model subjects and the recapture lint (RTC01-03) "
                        "and collective lints (PAR04, COL01) on source "
                        "paths")
    p.add_argument("--mesh", action="append", dest="meshes", metavar="SPEC",
                   help="mesh for --parallel/--linalg as axis=size "
                        "pairs, e.g. 'data=4,model=2'; repeatable "
                        "(default: the canonical dp4xtp2 and dp2xpp4 "
                        "meshes; --linalg defaults to dp4xtp2 only)")
    p.add_argument("--concurrency", action="store_true",
                   help="run the thread-safety lint (THR01-04) over "
                        "the given source paths (default: the port's "
                        "threaded serving/runtime tier)")
    p.add_argument("--failpaths", action="store_true",
                   help="run the failure-path lint (FLT01-06: "
                        "swallowed excepts, "
                        "seam-less dispatch boundaries, unbounded "
                        "blocking/retry, seams under locks, seam-name "
                        "integrity) over the given source paths "
                        "(default: the port's threaded tier)")
    p.add_argument("--linalg", action="store_true",
                   help="validate the canonical distributed-linalg block "
                        "plans (SUMMA GEMM, tall Gram, randomized SVD, CG "
                        "least squares): PAR01/03 placement, PAR04 the "
                        "collective lints over the linalg sources, PAR06 "
                        "per-rank bills vs --hbm-gb (linalg/plan.py)")
    p.add_argument("--hbm-gb", type=float, default=None,
                   help="per-card memory budget in GB (1e9 bytes) for "
                        "the PAR06 fit prediction (default: the visible "
                        "card's total memory; with no card and no "
                        "budget the prediction is reported but never "
                        "fails)")
    p.add_argument("--attribution", nargs="?", const="lenet",
                   metavar="SUBJECT",
                   help="run SUBJECT's train step and print its memory-"
                        "traffic attribution (util/hbm_ledger.py: floor "
                        "vs layout/dtype/re-read bins) + dtype-policy "
                        "audit; subjects: lenet (default), "
                        "resnet_block")
    p.add_argument("--precompile", nargs="?", const="all",
                   metavar="SUBJECT",
                   help="capture SUBJECT's train step (runtime.aot; "
                        "lenet, resnet_block, or 'all') and print "
                        "per-key capture seconds; its warm-start records "
                        "persist to --cache-dir (or $DL4J_TPU_AOT_CACHE)")
    p.add_argument("--autotune", nargs="?", const="all",
                   metavar="SUBJECT",
                   help="run the autotune arbiter (runtime/autotune.py) "
                        "over SUBJECT (lenet, resnet_block, or 'all'): "
                        "sweep the knobs, prove loss parity per "
                        "candidate, score by captured step time on the "
                        "card (bytes on the CPU), persist winners to "
                        "--cache-dir (or $DL4J_TPU_AUTOTUNE_CACHE). Exit "
                        "1 if a bitwise-contract candidate failed "
                        "parity")
    p.add_argument("--force", action="store_true",
                   help="with --autotune: re-sweep even when a "
                        "persisted record exists")
    p.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="executable-cache directory for --precompile/"
                        "--attribution/--autotune (default: "
                        "$DL4J_TPU_AOT_CACHE, else memory-only; "
                        "--autotune stores its .tune.json records in "
                        "the same directory)")
    p.add_argument("--device", default=None,
                   help="device of --attribution/--precompile/--autotune "
                        "(default: the card; 'cpu' to run on the host)")
    return p


#: the meshes --parallel validates against when --mesh is not given:
#: the two canonical 8-card plans (dp4xtp2 and
#: dp2xpp4)
CANONICAL_MESHES = ({"data": 4, "model": 2}, {"data": 2, "pipe": 4})


def _report_to_json(name, report, wall_s=None):
    rec = {
        "subject": name,
        "errors": [d.format() for d in report.errors],
        "warnings": [d.format() for d in report.warnings],
        "suppressed": [d.format() for d in report.suppressed],
        "codes": report.codes(),
    }
    if report.layers:
        rec["layers"] = report.layers
        rec["total_params"] = report.totalParams()
    if getattr(report, "plan", None) is not None:
        rec["plan"] = report.plan
    if wall_s is not None:
        rec["wall_s"] = round(wall_s, 4)
    return rec


def _validate_model_file(path, batch_size):
    from deeplearning4j_tpu_torch.analysis.shapes import validate_model
    from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.conf.graph import (
        ComputationGraphConfiguration,
    )

    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    errors = []
    for cls in (MultiLayerConfiguration, ComputationGraphConfiguration):
        try:
            conf = cls.fromJson(text)
            return validate_model(conf, batchSize=batch_size)
        except Exception as e:
            errors.append(f"{cls.__name__}: {e}")
    from deeplearning4j_tpu_torch.analysis.diagnostics import ERROR, Report

    rep = Report(subject=path)
    rep.add("SHP05", ERROR, path,
            "not a loadable model config: " + "; ".join(errors))
    return rep


def _validate_plan_file(path, axes, batch_size, hbm_gb):
    from deeplearning4j_tpu_torch.analysis import validate_plan
    from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.conf.graph import (
        ComputationGraphConfiguration,
    )

    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    errors = []
    for cls in (MultiLayerConfiguration, ComputationGraphConfiguration):
        try:
            conf = cls.fromJson(text)
        except Exception as e:
            errors.append(f"{cls.__name__}: {e}")
            continue
        return validate_plan(conf, axes, batchSize=batch_size,
                             hbm_gb=hbm_gb)
    from deeplearning4j_tpu_torch.analysis.diagnostics import ERROR, Report

    rep = Report(subject=path)
    rep.add("SHP05", ERROR, path,
            "not a loadable model config: " + "; ".join(errors))
    return rep


def run_zoo(batch_size=32):
    """Validate the whole zoo corpus; -> [(name, Report, wall_s)]."""
    from deeplearning4j_tpu_torch.analysis import validate_model, zoo_corpus

    out = []
    for name, model in zoo_corpus():
        t0 = time.perf_counter()
        rep = validate_model(model, batchSize=batch_size)
        out.append((name, rep, time.perf_counter() - t0))
    return out


def run_zoo_parallel(meshes, batch_size=32, hbm_gb=None):
    """Partition-plan validation of the zoo corpus on every mesh;
    -> [("Model@mesh", Report, wall_s)]."""
    from deeplearning4j_tpu_torch.analysis import validate_plan, zoo_corpus
    from deeplearning4j_tpu_torch.analysis.partitioning import _mesh_tag

    out = []
    for axes in meshes:
        tag = _mesh_tag(axes)
        for name, model in zoo_corpus():
            t0 = time.perf_counter()
            rep = validate_plan(model, axes, batchSize=batch_size,
                                hbm_gb=hbm_gb)
            out.append((f"{name}@{tag}", rep, time.perf_counter() - t0))
    return out


def main(argv=None):
    args = _build_parser().parse_args(argv)

    if args.codes:
        from deeplearning4j_tpu_torch.analysis.diagnostics import ALL_CODES

        for code, desc in ALL_CODES.items():
            print(f"{code}  {desc}")
        return 0

    # each of these subjects RETURNS from its own block, so combining
    # any two would silently swallow the second one's exit status and
    # un-gate a CI wired to the combined command — at most ONE may be
    # requested per invocation (zoo/paths form one combined subject)
    selected = [name for name, on in (
        ("--autotune", bool(args.autotune)),
        ("--precompile", bool(args.precompile)),
        ("--attribution", bool(args.attribution)),
        ("--linalg", args.linalg),
        # --concurrency/--failpaths own the paths when given (they are
        # their lint subject), so each conflicts with every other
        # subject
        ("--concurrency", args.concurrency),
        ("--failpaths", args.failpaths),
        # --parallel is a modifier OF the zoo/paths subject
        ("--zoo/paths", bool(args.zoo or (args.paths
                                          and not args.concurrency
                                          and not args.failpaths)
                             or args.parallel)),
    ) if on]
    if len(selected) > 1:
        print(" + ".join(selected) + ": these subjects each own the "
              "exit status; run them as separate commands",
              file=sys.stderr)
        return 2

    aot_cache = None
    if args.cache_dir or args.precompile or args.attribution \
            or args.autotune:
        # an explicit dir (or the env var) turns on the persistent tier
        # for every compile this command pays; the handle is kept so
        # the --precompile report works even when the session cache is
        # vetoed (DL4J_TPU_AOT=off / multihost make session_cache()
        # return None — an explicitly-passed cache still functions)
        from deeplearning4j_tpu_torch.runtime import aot

        aot_cache = aot.enable(args.cache_dir)

    if args.concurrency:
        import os as _os

        from deeplearning4j_tpu_torch.analysis.threads import (
            lint_thread_paths, threaded_tier_paths,
        )

        paths = args.paths or None
        if paths:
            missing = [p for p in paths if not _os.path.exists(p)]
            if missing:
                # same vacuous-pass guard as the purity subject: a
                # typo'd path must not un-gate a CI wired to this
                print("no such path(s): " + ", ".join(missing),
                      file=sys.stderr)
                return 2
        rep = lint_thread_paths(paths)
        shown = paths if paths else \
            [_os.path.relpath(p) for p in threaded_tier_paths()]
        rep.subject = "threads:" + ",".join(shown)
        if args.as_json:
            print(_json.dumps(
                {"reports": [_report_to_json(rep.subject, rep)],
                 "ok": rep.ok}, indent=2))
        else:
            print(rep.format(verbose=args.verbose))
            print(f"\n1 subject(s): {len(rep.errors)} error(s), "
                  f"{len(rep.warnings)} warning(s)")
        return 0 if rep.ok else 1

    if args.failpaths:
        import os as _os

        from deeplearning4j_tpu_torch.analysis.faults import lint_fault_paths
        from deeplearning4j_tpu_torch.analysis.threads import threaded_tier_paths

        paths = args.paths or None
        if paths:
            missing = [p for p in paths if not _os.path.exists(p)]
            if missing:
                # same vacuous-pass guard as the other lint subjects: a
                # typo'd path must not un-gate a CI wired to this
                print("no such path(s): " + ", ".join(missing),
                      file=sys.stderr)
                return 2
        rep = lint_fault_paths(paths)
        shown = paths if paths else \
            [_os.path.relpath(p) for p in threaded_tier_paths()]
        rep.subject = "faults:" + ",".join(shown)
        if args.as_json:
            print(_json.dumps(
                {"reports": [_report_to_json(rep.subject, rep)],
                 "ok": rep.ok}, indent=2))
        else:
            print(rep.format(verbose=args.verbose))
            print(f"\n1 subject(s): {len(rep.errors)} error(s), "
                  f"{len(rep.warnings)} warning(s)")
        return 0 if rep.ok else 1

    if args.autotune:
        from deeplearning4j_tpu_torch.analysis.hbm import SUBJECTS
        from deeplearning4j_tpu_torch.runtime import autotune as _autotune

        tune_store = _autotune.enable(args.cache_dir)
        subjects = SUBJECTS if args.autotune == "all" \
            else (args.autotune,)
        results = {}
        try:
            for s in subjects:
                results[s] = _autotune.autotune_subject(
                    s, device=args.device, store_=tune_store,
                    force=args.force)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        # a bitwise-contract candidate (parity_rtol == 0: the
        # impl-swap knobs promise exact math) failing parity is a
        # kernel bug the CI gate must see; math-changing knobs being
        # rejected for tolerance is the arbiter working as designed.
        # Only FRESH sweeps count: a recalled record's historical
        # verdict must not keep CI red after the kernel is fixed
        # (records persist unconditionally; re-prove with --force)
        strict = {k.name for k in _autotune.KNOBS
                  if k.parity_rtol == 0.0}
        bitwise_fail = any(
            p["verdict"] == "parity-fail" and p["knob"] in strict
            for r in results.values() if r.swept for p in r.per_knob)
        if args.as_json:
            print(_json.dumps(
                {"subjects": {s: {"key": r.key, "swept": r.swept,
                                  "knobs": r.knobs,
                                  "baseline_bytes": r.baseline_bytes,
                                  "tuned_bytes": r.tuned_bytes,
                                  "per_knob": r.per_knob,
                                  "wall": r.wall}
                              for s, r in results.items()},
                 "store_dir": tune_store.directory,
                 "bitwise_parity_failure": bitwise_fail}, indent=2))
        else:
            for s, r in results.items():
                print(f"{s}:")
                print("  " + r.format().replace("\n", "\n  "))
            where = tune_store.directory or \
                "memory only (set --cache-dir or " \
                "$DL4J_TPU_AUTOTUNE_CACHE to persist)"
            print(f"\nstore: {where}")
            if bitwise_fail:
                print("ERROR: a bitwise-contract knob candidate failed "
                      "loss parity — a kernel impl diverged from the "
                      "stock lowering", file=sys.stderr)
        return 1 if bitwise_fail else 0

    if args.precompile:
        from deeplearning4j_tpu_torch.analysis.hbm import (SUBJECTS,
                                                     precompile_subject)

        subjects = SUBJECTS if args.precompile == "all" \
            else (args.precompile,)
        records = {}
        try:
            for s in subjects:
                records[s] = precompile_subject(
                    s, batch_size=args.batch_size, cache=aot_cache,
                    device=args.device)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        cache = aot_cache
        if args.as_json:
            print(_json.dumps({"subjects": records,
                               "cache_dir": cache.directory,
                               "stats": cache.stats}, indent=2))
        else:
            for s, rep in records.items():
                print(f"{s}:")
                for entry, r in rep.items():
                    print(f"  {entry:<24} {r['status']:<5} "
                          f"{r['seconds']:>8.3f} s  {r['key'][:16]}")
            total = sum(r["seconds"] for rep in records.values()
                        for r in rep.values())
            where = cache.directory or "memory only (set --cache-dir or "\
                                       "$DL4J_TPU_AOT_CACHE to persist)"
            print(f"\n{sum(len(r) for r in records.values())} key(s), "
                  f"{total:.1f} s total; cache: {where}")
        return 0

    if args.attribution:
        from deeplearning4j_tpu_torch.analysis.hbm import run_attribution

        try:
            rec, text = run_attribution(args.attribution,
                                        batch_size=args.batch_size,
                                        device=args.device)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        if args.as_json:
            print(_json.dumps(rec, indent=2))
        else:
            print(text)
        # a dtype-policy leak in the bf16 subject is an error a CI gate
        # wired to this command must see
        return 1 if rec["wide_activation_buffers"] else 0

    if args.linalg:
        from deeplearning4j_tpu_torch.analysis.partitioning import (
            _mesh_tag, normalize_mesh,
        )
        from deeplearning4j_tpu_torch.linalg.plan import (
            CANONICAL_LINALG_MESH, validate_linalg_plan,
        )

        try:
            meshes = ([normalize_mesh(m) for m in args.meshes]
                      if args.meshes else [dict(CANONICAL_LINALG_MESH)])
        except (ValueError, TypeError) as e:
            print(f"bad --mesh: {e}", file=sys.stderr)
            return 2
        records = []
        for axes in meshes:
            rep = validate_linalg_plan(axes, hbm_gb=args.hbm_gb)
            rep.subject = f"linalg@{_mesh_tag(axes)}"
            records.append(rep)
        had_error = any(not r.ok for r in records)
        if args.as_json:
            print(_json.dumps(
                {"reports": [_report_to_json(r.subject, r)
                             for r in records], "ok": not had_error},
                indent=2))
        else:
            for rep in records:
                print(rep.format(verbose=args.verbose))
            print(f"\n{len(records)} subject(s): "
                  f"{sum(len(r.errors) for r in records)} error(s), "
                  f"{sum(len(r.warnings) for r in records)} warning(s)")
        return 1 if had_error else 0

    if not args.zoo and not args.paths:
        _build_parser().print_usage()
        return 2

    import os

    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        # a typo'd path must NOT pass vacuously — a CI gate wired to
        # this command would silently stop gating. Checked before any
        # work so the usage error is instant.
        print("no such path(s): " + ", ".join(missing), file=sys.stderr)
        return 2

    meshes = None
    if args.parallel:
        from deeplearning4j_tpu_torch.analysis.partitioning import normalize_mesh

        try:
            meshes = ([normalize_mesh(m) for m in args.meshes]
                      if args.meshes else list(CANONICAL_MESHES))
        except (ValueError, TypeError) as e:
            print(f"bad --mesh: {e}", file=sys.stderr)
            return 2
    elif args.meshes or args.hbm_gb is not None:
        print("--mesh/--hbm-gb require --parallel", file=sys.stderr)
        return 2

    records = []
    had_error = False

    if args.zoo:
        if args.parallel:
            results = run_zoo_parallel(meshes, args.batch_size,
                                       hbm_gb=args.hbm_gb)
        else:
            results = run_zoo(args.batch_size)
        for name, rep, wall in results:
            records.append((name, rep, wall))
            had_error = had_error or not rep.ok

    src_paths = []
    for path in args.paths:
        if path.endswith(".json"):
            try:
                if args.parallel:
                    from deeplearning4j_tpu_torch.analysis.partitioning import (
                        _mesh_tag,
                    )

                    for axes in meshes:
                        rep = _validate_plan_file(path, axes,
                                                  args.batch_size,
                                                  args.hbm_gb)
                        records.append((f"{path}@{_mesh_tag(axes)}",
                                        rep, None))
                        had_error = had_error or not rep.ok
                else:
                    rep = _validate_model_file(path, args.batch_size)
                    records.append((path, rep, None))
                    had_error = had_error or not rep.ok
            except OSError as e:
                print(f"cannot read {path}: {e}", file=sys.stderr)
                return 2
        else:
            src_paths.append(path)
    if src_paths:
        from deeplearning4j_tpu_torch.analysis.purity import (
            iter_py_files, lint_paths,
        )

        if not any(True for _ in iter_py_files(src_paths)):
            # an existing path that contributes no lintable .py file
            # (e.g. model.jsn typo) must not pass vacuously either
            print("no .py files under: " + ", ".join(src_paths),
                  file=sys.stderr)
            return 2
        rep = lint_paths(src_paths)
        records.append(("purity:" + ",".join(src_paths), rep, None))
        had_error = had_error or not rep.ok
        if args.parallel:
            from deeplearning4j_tpu_torch.analysis.partitioning import (
                check_collectives,
            )
            from deeplearning4j_tpu_torch.analysis.retrace import (
                lint_retrace_paths,
            )

            rep = lint_retrace_paths(src_paths)
            records.append(("retrace:" + ",".join(src_paths), rep, None))
            had_error = had_error or not rep.ok
            from deeplearning4j_tpu_torch.analysis.collectives import (
                lint_collective_paths,
            )

            rep = lint_collective_paths(src_paths)
            records.append(("rank-branches:" + ",".join(src_paths), rep,
                            None))
            had_error = had_error or not rep.ok
            # collective axes are valid when any requested mesh has them
            axes = set()
            for m in meshes:
                axes |= set(m)
            from deeplearning4j_tpu_torch.analysis.diagnostics import Report

            crep = Report(subject="collectives")
            for f in iter_py_files(src_paths):
                try:
                    with open(f, "r", encoding="utf-8") as fh:
                        crep.extend(check_collectives(fh.read(), axes,
                                                      path=f))
                except OSError as e:
                    crep.add("LNT00", "error", f, f"unreadable: {e}")
            records.append(("collectives:" + ",".join(src_paths), crep,
                            None))
            had_error = had_error or not crep.ok

    if args.as_json:
        print(_json.dumps(
            {"reports": [_report_to_json(n, r, w) for n, r, w in records],
             "ok": not had_error}, indent=2))
    else:
        for name, rep, wall in records:
            rep.subject = name
            print(rep.format(verbose=args.verbose))
            if wall is not None and args.verbose:
                print(f"  ({wall * 1e3:.1f} ms)")
        n_err = sum(len(r.errors) for _, r, _ in records)
        n_warn = sum(len(r.warnings) for _, r, _ in records)
        print(f"\n{len(records)} subject(s): {n_err} error(s), "
              f"{n_warn} warning(s)")
    return 1 if had_error else 0
