"""The reference's `experiments/multi_dataset_framework.py` entry point on
the port: joint IEMOCAP + RAVDESS + MELD training and the cross-dataset
transfer matrix, from `tpu_deer_torch.train.multi_dataset`.

    python -m tpu_deer_torch.experiments.multi_dataset_framework --quick

It runs on the card unless `--platform cpu` is given.
"""

import sys

from tpu_deer_torch.train.multi_dataset import main

if __name__ == "__main__":
    sys.exit(main())
