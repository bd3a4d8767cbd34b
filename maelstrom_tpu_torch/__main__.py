"""`python -m maelstrom_tpu_torch test ...`: see `maelstrom_tpu_torch.cli`."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
