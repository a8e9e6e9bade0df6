"""`python -m sparkfm_tpu_torch` entry point (``cli.py``)."""

import sys

from sparkfm_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
