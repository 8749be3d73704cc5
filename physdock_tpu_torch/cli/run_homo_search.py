"""Homology-search CLI (reference: run_homo_search.py).

    python -m physdock_tpu_torch.cli.run_homo_search -f fastas/ -o out/ \
        --uniref90 PATH --uniprot PATH --mgnify PATH --bfd PATH --uniclust30 PATH
"""

from __future__ import annotations

import argparse
import glob
import os

from physdock_tpu_torch.data.msa.search import SearchConfig, run_homo_search


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-f", "--fasta_dir", required=True)
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("--uniref90", default=None)
    p.add_argument("--uniprot", default=None)
    p.add_argument("--mgnify", default=None)
    p.add_argument("--bfd", default=None)
    p.add_argument("--uniclust30", default=None)
    p.add_argument("--n_cpu", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=4)
    args = p.parse_args(argv)

    fastas = sorted(glob.glob(os.path.join(args.fasta_dir, "*.fasta")))
    if not fastas:
        p.error(f"no .fasta files under {args.fasta_dir}")
    cfg = SearchConfig(
        uniref90_path=args.uniref90,
        uniprot_path=args.uniprot,
        mgnify_path=args.mgnify,
        bfd_path=args.bfd,
        uniclust30_path=args.uniclust30,
        n_cpu=args.n_cpu,
    )
    run_homo_search(fastas, args.output_dir, cfg, args.num_workers)
    print(f"msa features written under {args.output_dir}")


if __name__ == "__main__":
    main()
