"""Command-line entry points — counterpart of tpulsar/cli/.  So far the
per-beam job: ``python -m tpulsar_torch.cli.search_job``."""
