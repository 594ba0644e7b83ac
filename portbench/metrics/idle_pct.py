"""Share of the traced request's wall time in which no device activity
ran (the union of the device's activities), in %."""

from portbench.trace import busy_s


def read(trace):
    return 100.0 * (1.0 - busy_s(trace.events) / trace.wall_s)
