"""Training: steps, optimizer, sparse tables, checkpoints, the trainer and
the training CLI (``python -m jodalrob_twotower_torch.train``)."""


def main(argv=None) -> int:
    """The training CLI (train/cli.py) in-process: returns its exit code."""
    from jodalrob_twotower_torch.train.cli import main as cli_main

    return cli_main(argv)
