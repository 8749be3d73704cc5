"""Redocking CLI (port of `physdock_tpu/cli/redocking.py`).

Predict poses of known ligands in prepared systems:
    python -m physdock_tpu_torch.cli.redocking -i SYSTEM.pkl.gz -o out/ [...]
    python -m physdock_tpu_torch.cli.redocking -f SYSTEMS_DIR -o out/ [...]

Runs on CUDA unless `--device cpu` is given.  More than one system goes
through `DockingPipeline.dock_many`: on CUDA a featurizer worker process
loads system k+1 while system k docks (the first is featurized in
process while the worker starts), and `--dock_batch_size N` stacks up to N systems of one MSA
depth into one sampler pass.  If `dock_many` fails, the systems without
outputs dock one after the other; a system that fails there is recorded
as {"system_id", "error"} and the rest go on.  An error that names the
card (CUDA out of memory, a CUDA or accelerator error) is never recorded:
it ends the run.  Every system with a reference ligand
gets `bust_report.json` (pose checks of the written top 5);
`--enable_sidechain_relaxation` relaxes every pose before ranking.
`--enable_confidence` scores every pose with the confidence head (params
trained with it, e.g. `_confidence/ema_params_conf.npz`) into
`confidence.json`; `--confidence_ranking` also ranks the poses by it.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import traceback

import torch

from physdock_tpu_torch.cli.common import add_common_flags, build_pipeline
from physdock_tpu_torch.utils.io import dump_json
from physdock_tpu_torch.utils.profiling import device_trace


def names_the_card(e: BaseException) -> bool:
    """True for an error of the card itself, which no fallback may hide."""
    accel = getattr(torch, "AcceleratorError", None)
    return (isinstance(e, torch.cuda.OutOfMemoryError)
            or (accel is not None and isinstance(e, accel))
            or (isinstance(e, RuntimeError) and "CUDA" in str(e)))


def _name(sys_pkl: str) -> str:
    return os.path.basename(sys_pkl).replace(".pkl.gz", "")


def _done(output_dir: str, sys_pkl: str) -> bool:
    return os.path.exists(os.path.join(output_dir, _name(sys_pkl), "top5_rmsd.json"))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--input_pkl", default=None)
    p.add_argument("-f", "--input_dir", default=None)
    p.add_argument("--ligand_sdf", default=None)
    p.add_argument("--ligand_smi", default=None)
    p.add_argument("--dock_batch_size", type=int, default=1,
                   help="stack up to this many systems of one MSA depth into one sampler "
                        "pass (1 = one system after the other, featurization prefetched)")
    add_common_flags(p)
    args = p.parse_args(argv)
    if args.dock_batch_size < 1:
        p.error("--dock_batch_size must be >= 1")

    systems = []
    if args.input_pkl:
        systems = [args.input_pkl]
    elif args.input_dir:
        systems = sorted(glob.glob(os.path.join(args.input_dir, "*.pkl.gz")))
    if not systems:
        p.error("provide -i or -f with systems")

    todo = []
    for sys_pkl in systems:
        if _done(args.output_dir, sys_pkl):
            print(f"[skip] {_name(sys_pkl)}: outputs exist", flush=True)
            continue
        todo.append(sys_pkl)
    pipe = build_pipeline(args)
    try:
        with device_trace(args.trace_dir if pipe.writes else None):
            results = _dock_all(pipe, args, todo)
    finally:
        pipe.close()
    dump_json(results, os.path.join(args.output_dir, "summary.json"))
    return results


def _dock_all(pipe, args, todo):
    results = []
    if len(todo) > 1:
        try:
            # featurization prefetched behind the card's rounds; optional
            # cross-system batching
            pipe.dock_many(todo, args.output_dir, ligand_sdf=args.ligand_sdf,
                           smi=args.ligand_smi, batch_size=args.dock_batch_size,
                           results=results)
            for r in results:
                print(f"[done] {r['system_id']}: top5_rmsd={r['top5_rmsd']} "
                      f"({r['total_time_s']} s)", flush=True)
            return results
        except Exception as e:
            if names_the_card(e):
                raise
            traceback.print_exc(file=sys.stderr)
            print(f"[dock_many failed: {type(e).__name__}: {e}; falling back to sequential]",
                  flush=True)
            # dock_many may have died with responses still queued in the
            # worker's pipe: the fallback needs a clean worker
            if hasattr(pipe.featurizer, "respawn"):
                pipe.featurizer.respawn()
            todo = [s for s in todo if not _done(args.output_dir, s)]
    for sys_pkl in todo:
        name = _name(sys_pkl)
        try:
            r = pipe.dock(sys_pkl, os.path.join(args.output_dir, name),
                          ligand_sdf=args.ligand_sdf, smi=args.ligand_smi)
        except Exception as e:  # per-system robustness (redocking.py:454-456)
            if names_the_card(e):
                raise
            traceback.print_exc(file=sys.stderr)
            print(f"[fail] {name}: {type(e).__name__}: {e}", flush=True)
            results.append({"system_id": name, "error": str(e)})
            continue
        results.append(r)
        print(f"[done] {name}: top5_rmsd={r['top5_rmsd']} ({r['total_time_s']} s)", flush=True)
    return results


if __name__ == "__main__":
    main()
