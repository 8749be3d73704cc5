"""Virtual-screening CLI (port of `physdock_tpu/cli/screening.py`).

Dock a SMILES library into one receptor pocket:
    python -m physdock_tpu_torch.cli.screening -i RECEPTOR.pkl.gz -s smiles.txt -o out/ [...]

The GT ligand of the system pkl defines the pocket and crop centre; the
ligand itself is replaced by each query SMILES.  Outputs go to
`out/md5(smi)/`, with `smiles_to_md5.json` and `screening_results.json`
(`screening_results.shardNNN.json` for one shard of several).  Runs on
CUDA unless `--device cpu` is given.  The confidence flags score each
ligand's poses when ligands dock one at a time (`--vs_batch_size 1`); the
batched screen scores no confidence, as in the JAX package.
"""

from __future__ import annotations

import argparse
import os

from physdock_tpu_torch.cli.common import add_common_flags, build_pipeline
from physdock_tpu_torch.utils.io import dump_json, load_txt


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--input_pkl", required=True)
    p.add_argument("-s", "--smiles_txt", required=True)
    p.add_argument("--vs_batch_size", type=int, default=1,
                   help="ligands docked at a time, each group of same-shaped ligand-systems "
                        "in one sampler pass (1 = one ligand after the other)")
    p.add_argument("--num_shards", type=int, default=1,
                   help="split the library across N independent processes; per-ligand "
                        "output directories are md5-keyed, so shards share one output dir")
    p.add_argument("--shard_id", type=int, default=0)
    add_common_flags(p)
    args = p.parse_args(argv)
    if not 0 <= args.shard_id < args.num_shards:
        p.error(f"--shard_id {args.shard_id} not in [0, --num_shards {args.num_shards})")
    if args.vs_batch_size < 1:
        p.error("--vs_batch_size must be >= 1")

    smiles = load_txt(args.smiles_txt)
    if args.num_shards > 1:
        smiles = smiles[args.shard_id:: args.num_shards]
        print(f"[screen] shard {args.shard_id}/{args.num_shards}: {len(smiles)} ligands",
              flush=True)
    pipe = build_pipeline(args)
    try:
        results = pipe.screen(args.input_pkl, smiles, args.output_dir,
                              batch_size=args.vs_batch_size)
    finally:
        pipe.close()
    name = ("screening_results.json" if args.num_shards == 1
            else f"screening_results.shard{args.shard_id:03d}.json")
    dump_json(results, os.path.join(args.output_dir, name))
    for r in results:
        tag = r.get("error", f"poses={r.get('num_poses')}")
        print(f"[screen] {r['smiles'][:50]}: {tag}", flush=True)
    return results


if __name__ == "__main__":
    main()
