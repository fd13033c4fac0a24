"""The reference's `experiments/run_multimodal_deer.py` entry point on the
port: the CLI's modes (full, train, evaluate, visualize, test, export),
`--config`, `--quick` and the overrides, from `tpu_deer_torch.cli`.

    python -m tpu_deer_torch.experiments.run_multimodal_deer --mode test

It runs on the card unless `--platform cpu` is given.
"""

import sys

from tpu_deer_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
