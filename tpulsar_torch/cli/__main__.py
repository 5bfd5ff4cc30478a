"""``python -m tpulsar_torch.cli <subcommand>`` — the operator CLI
(main.py), the same as ``python -m tpulsar_torch``."""

from tpulsar_torch.cli.main import main

raise SystemExit(main())
