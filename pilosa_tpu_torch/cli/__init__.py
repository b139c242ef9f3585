"""Command-line interface: ``python -m pilosa_tpu_torch.cli server ...``."""

from pilosa_tpu_torch.cli.main import main

__all__ = ["main"]
