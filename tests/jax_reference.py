"""Helpers shared by the port's tests for calling the JAX package's code."""

import jax

# the reference exchanges' dss_T, each compiled once as one program (called
# eagerly, each of its operations compiles on its own); keyed by the
# exchange, which the entry keeps alive
_DSS_T = {}


def jit_dss_T(ex):
    """``jax.jit(ex.dss_T)``, built once per exchange."""
    if id(ex) not in _DSS_T:
        _DSS_T[id(ex)] = (ex, jax.jit(ex.dss_T))
    return _DSS_T[id(ex)][1]
