"""``python -m tpulsar_torch.analysis`` — the lint entry point (no
torch; ``python -m tpulsar_torch lint`` is the same code behind the
operator CLI)."""

import sys

from tpulsar_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
