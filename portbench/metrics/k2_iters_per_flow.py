"""K2's primal-dual iterations per TV-L1 flow of the traced request: the
request span's ``k2_iterations`` counter (``flow/tvl1_cuda.py``'s
``ITERATIONS``, taken on the device at the request's entry and exit) over
its ``bnlk.flow`` spans. Tells fewer iterations from faster ones, which
``flow_ms_per_frame`` cannot. None without flow spans or without a K2
iteration counted."""

from portbench.spans import last_request


def read(trace):
    req = last_request()
    if req is None or not req.count("flow") or not req.counters.get("k2_iterations"):
        return None
    return req.counters["k2_iterations"] / req.count("flow")
