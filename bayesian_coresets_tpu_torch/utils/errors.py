"""Error types (reference: bayesiancoresets/util/errors.py:1).

``NumericalPrecisionError`` is a host-side error for eager validation (e.g.
a projection matrix with zero norm handed to a solver factory).  Inside the
build loop the same condition is a status flag in the solver state
(``SNNLSState.done`` / ``fail``), as in the JAX package.
"""


class NumericalPrecisionError(Exception):
    """Raised on the host path when numeric limits make progress impossible."""
