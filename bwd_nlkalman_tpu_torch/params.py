"""NL-Kalman parameters, shared with the JAX package.

``bwd_nlkalman_tpu.params`` imports no JAX (and the JAX package's
``__init__`` imports only it), so both packages use the very same
parameter objects: a ``NLKParams`` resolved for one package is valid for
the other.
"""

from bwd_nlkalman_tpu.params import FilterMode, NLKParams, default_params

__all__ = ["FilterMode", "NLKParams", "default_params"]
