"""Counter unwrapping (port of ``unwrap_counter`` from
``repro/core/reconstruction.py``): host-side numpy used by the packer."""
from __future__ import annotations

import numpy as np


def unwrap_counter(values, wrap_bits=0, quantum=1.0, *, period=None):
    """Undo cumulative-counter wraparound.

    The wrap period is DECLARED by the caller — either explicitly via
    ``period`` (value units) or as ``2**wrap_bits * quantum`` ticks —
    never inferred from the observed deltas.
    """
    if period is None:
        period = (2.0 ** wrap_bits) * quantum if wrap_bits else 0.0
    if not period:
        return np.asarray(values, np.float64)
    v = np.asarray(values, np.float64)
    jumps = np.diff(v) < -0.5 * period
    wraps = np.concatenate([[0.0], np.cumsum(jumps.astype(np.float64))])
    return v + wraps * period
