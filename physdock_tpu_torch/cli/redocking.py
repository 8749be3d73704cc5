"""Redocking CLI (port of `physdock_tpu/cli/redocking.py`).

Predict poses of known ligands in prepared systems:
    python -m physdock_tpu_torch.cli.redocking -i SYSTEM.pkl.gz -o out/ [...]
    python -m physdock_tpu_torch.cli.redocking -f SYSTEMS_DIR -o out/ [...]

Runs on CUDA unless `--device cpu` is given.  Systems dock one after the
other; a system that fails ends the run with its error (non-zero exit).
`--enable_confidence` scores every pose with the confidence head (params
trained with it, e.g. `_confidence/ema_params_conf.npz`) into
`confidence.json`; `--confidence_ranking` also ranks the poses by it.
"""

from __future__ import annotations

import argparse
import glob
import os

from physdock_tpu_torch.cli.common import add_common_flags, build_pipeline
from physdock_tpu_torch.utils.io import dump_json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--input_pkl", default=None)
    p.add_argument("-f", "--input_dir", default=None)
    p.add_argument("--ligand_sdf", default=None)
    p.add_argument("--ligand_smi", default=None)
    add_common_flags(p)
    args = p.parse_args(argv)

    systems = []
    if args.input_pkl:
        systems = [args.input_pkl]
    elif args.input_dir:
        systems = sorted(glob.glob(os.path.join(args.input_dir, "*.pkl.gz")))
    if not systems:
        p.error("provide -i or -f with systems")

    pipe = build_pipeline(args)
    results = []
    for sys_pkl in systems:
        name = os.path.basename(sys_pkl).replace(".pkl.gz", "")
        if os.path.exists(os.path.join(args.output_dir, name, "top5_rmsd.json")):
            print(f"[skip] {name}: outputs exist", flush=True)
            continue
        r = pipe.dock(sys_pkl, os.path.join(args.output_dir, name),
                      ligand_sdf=args.ligand_sdf, smi=args.ligand_smi)
        results.append(r)
        print(f"[done] {name}: top5_rmsd={r['top5_rmsd']} ({r['total_time_s']} s)", flush=True)
    dump_json(results, os.path.join(args.output_dir, "summary.json"))
    return results


if __name__ == "__main__":
    main()
