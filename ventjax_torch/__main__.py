"""``python -m ventjax_torch``: the port's command line (cli.py)."""
import sys

from ventjax_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
