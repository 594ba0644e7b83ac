"""The drivers' own time, in ms per frame of the traced request: the
device extent of the ``bnlk.request`` span less its child spans' (flows,
occlusion masks, warps, NL-Kalman passes). What is left is the drivers'
kernels (colour, ``luma``, stacks) and the device's waits while the host
is in driver code (``pipeline/sequence.py``'s loops). None without a
request span."""

from portbench.spans import last_request


def read(trace):
    req = last_request()
    if req is None or not req.spans:
        return None
    return req.self_ms(0) / trace.frames
