"""``python -m repro_torch.analysis [paths] [--strict-suppressions]``."""

import sys

from repro_torch.analysis.lint import main

if __name__ == "__main__":
    sys.exit(main())
