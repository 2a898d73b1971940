"""Host work of a batch's lanes, spread over the host's cores.

The batched scheduler's host steps (the constraint operator's Gram matrix
and Cholesky factor, the float64 post-processing of each solution, each
lane's Gaussians and analysis bounds) are independent per lane and spend
their time in numpy and scipy routines that release the GIL, so a pool of
threads runs them side by side.  Results keep the lanes' order, and each
lane's work is the same as when run alone.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor


def lane_map(fn, *iterables) -> list:
    """``[fn(*args) for args in zip(*iterables)]``, one thread a lane up to
    the host's core count."""
    jobs = list(zip(*iterables))
    workers = min(len(jobs), os.cpu_count() or 1)
    if workers <= 1:
        return [fn(*args) for args in jobs]
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(lambda args: fn(*args), jobs))
