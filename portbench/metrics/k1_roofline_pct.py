"""K1's share of its roofline over the traced request, in %: the least
time the card could take for the request's NL-Kalman passes (counted from
shapes and pass parameters, ``roofline.k1_pass_work``) over K1's device
time, its four kernels summed. None where no K1 kernel ran."""

from portbench.roofline import bound_s

K1 = ("dct_kernel", "site_kernel", "aggregate_kernel", "fold_kernel")


def read(trace):
    t = trace.seconds_where(lambda n: n.startswith(K1))
    if t <= 0.0 or not trace.k1_passes:
        return None
    return 100.0 * sum(bound_s(f, b) for f, b in trace.k1_passes) / t
