"""The 95th percentile of the time of every job in the window, in ms
(numpy's linear interpolation between order statistics)."""

import numpy as np


def read(record):
    return 1e3 * float(np.percentile(np.asarray(record["job_s"]), 95))
