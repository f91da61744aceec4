"""`python -m image_analogies_tpu_torch` runs the command line (cli.py)."""

import sys

from .cli import main

sys.exit(main())
