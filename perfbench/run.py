"""One run of one benchmark cell of the PhysDock PyTorch port:

    python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Prints the result as the last line of standard output (see
`perfbench/lib/harness.py`) and exits 0; exits otherwise, printing no
result, without enough CUDA devices or when the process has loaded JAX or
the JAX package."""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from perfbench.lib.harness import main

    sys.exit(main(sys.argv[1:]))
