"""``python -m tpulsar_torch <subcommand>`` — the operator CLI
(cli/main.py)."""

from tpulsar_torch.cli.main import main

raise SystemExit(main())
