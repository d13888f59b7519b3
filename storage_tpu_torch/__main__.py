"""``python -m storage_tpu_torch`` — the CLI front-end (see storage_tpu_torch/cli.py)."""
import sys

from .cli import main

sys.exit(main())
