"""Command-line entry points — counterpart of tpulsar/cli/: the
operator CLI ``python -m tpulsar_torch`` (main.py, also runnable as
``python -m tpulsar_torch.cli``) and the per-beam job
``python -m tpulsar_torch.cli.search_job``."""
