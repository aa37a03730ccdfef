"""``python -m jodalrob_twotower_torch.train``: the training CLI (train/cli.py)."""

import sys

from jodalrob_twotower_torch.train.cli import main

if __name__ == "__main__":
    sys.exit(main())
