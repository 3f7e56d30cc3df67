"""``python -m mythril_tpu_torch`` — the ``myth`` console entry analog."""

import sys

from .interfaces.cli import main

sys.exit(main())
