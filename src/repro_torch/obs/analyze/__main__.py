"""``python -m repro_torch.obs.analyze``: see :mod:`.cli`."""
import sys

from repro_torch.obs.analyze.cli import main

if __name__ == "__main__":
    sys.exit(main())
