"""The program's record of its traced request, for the readers of the
layer spans and counters it keeps (``utils.profiling.last_request``).

The traced run profiles its request before the window, and the window
runs with tracing off, so the record still holds the traced request when
the readers run. A checkout of the program that keeps no such record
gives None, and so does each reader.
"""


def last_request():
    """The newest traced request's record, or None where the program keeps
    none."""
    try:
        from bwd_nlkalman_tpu_torch.utils.profiling import last_request
    except ImportError:
        return None
    return last_request()
