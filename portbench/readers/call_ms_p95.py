"""95th percentile of all public calls in the window, host clock, from
handing the arrays in to holding the scores; a call that raised counts as
longer than any (no value when those reach the percentile)."""

import math

import numpy as np


def read(run):
    times = np.array([r.ms if r.error is None else math.inf for r in run.window])
    value = float(np.percentile(times, 95, method="higher")) if len(times) else math.inf
    return value if math.isfinite(value) else None
