"""Command-line entry points — counterpart of tpulsar/cli/: the
operator CLI ``python -m tpulsar_torch`` (main.py; so far its
``serve`` subcommand) and the per-beam job
``python -m tpulsar_torch.cli.search_job``."""
