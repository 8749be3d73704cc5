"""System preparation CLI (reference: prepare_system.py).

    python -m physdock_tpu_torch.cli.prepare_system -r receptor.pdb -l ligand.sdf -o out/
"""

from __future__ import annotations

import argparse

from physdock_tpu_torch.data.system import generate_system


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--receptor_pdb", required=True)
    p.add_argument("-l", "--ligand_sdf", default=None)
    p.add_argument("-o", "--output_dir", default=".")
    p.add_argument("-n", "--name", default=None)
    args = p.parse_args(argv)
    path = generate_system(
        args.receptor_pdb, args.ligand_sdf, args.output_dir, args.name
    )
    print(f"system written: {path}")
    return path


if __name__ == "__main__":
    main()
