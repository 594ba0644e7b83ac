"""90th percentile of the request (clip) time over every request of the
window, in ms."""

import statistics


def read(window):
    if len(window.latencies) < 2:
        return None
    return 1e3 * statistics.quantiles(window.latencies, n=10, method="inclusive")[8]
