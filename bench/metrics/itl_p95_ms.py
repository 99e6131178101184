"""The 95th percentile of every gap between two successive output tokens of
one sequence, both inside the window, in ms.  Host clock."""

import numpy as np


def read(run):
    gaps = run.phase.gaps
    if not gaps:
        return None
    return float(np.percentile(np.asarray(gaps), 95)) * 1e3
