"""``python -m jodalrob_twotower_torch.etl``: the offline ETL CLI (etl/cli.py)."""

import sys

from jodalrob_twotower_torch.etl.cli import main

if __name__ == "__main__":
    sys.exit(main())
