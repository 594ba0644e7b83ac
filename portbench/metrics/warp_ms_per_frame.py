"""The warps and occlusion masks, in ms per frame of the traced request:
the device extent of its ``bnlk.warp`` spans (K4 on the card) and
``bnlk.occlusion`` spans (the divergence mask). None without either."""

from portbench.spans import last_request


def read(trace):
    req = last_request()
    if req is None or not req.count("warp") + req.count("occlusion"):
        return None
    return req.extent_ms("warp", "occlusion") / trace.frames
