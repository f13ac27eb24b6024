"""``query_p50_ms``: median over every query of the window of its time on
the host clock, from the call to its return after the card is done."""
import numpy as np


def read(win):
    return 1e3 * float(np.percentile(win.latencies_s, 50))
