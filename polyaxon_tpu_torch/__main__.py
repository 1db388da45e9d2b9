"""`python -m polyaxon_tpu_torch <command>`: the port's CLI."""

import sys

from .cli.main import main

if __name__ == "__main__":
    sys.exit(main())
