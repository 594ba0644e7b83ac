"""The flow's glue, in ms per frame of the traced request: the device
extent of its ``bnlk.flow`` spans less the device time of the flow's
kernels (``trace.FLOW_KERNEL``: K2, K3 and K4's TV-L1 entry). What is left
is the pyramid, the zooms and the blur products (cuBLAS), and the device's
waits for the host inside a flow. None without flow spans."""

from portbench.spans import last_request
from portbench.trace import FLOW_KERNEL


def read(trace):
    req = last_request()
    if req is None or not req.count("flow"):
        return None
    kernels_ms = 1e3 * trace.seconds_where(lambda n: FLOW_KERNEL.match(n) is not None)
    return (req.extent_ms("flow") - kernels_ms) / trace.frames
