"""Device ms of the TV-L1 flow's kernels per frame of the traced request:
K2's levels and rounds, K3's blocks and rounds and K4's TV-L1 entry. The
flow's glue (zooms, blur products) is not counted. None where no flow
kernel ran."""

from portbench.trace import FLOW_KERNEL


def read(trace):
    t = trace.seconds_where(lambda n: FLOW_KERNEL.match(n) is not None)
    return 1e3 * t / trace.frames if t > 0.0 else None
