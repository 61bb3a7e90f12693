"""HDF5 checkpoint/resume for parameter sweeps: a copy of the JAX
package's ``utils/checkpoint.py``.  ``h5py`` is imported only inside
:func:`open_results`; a machine without it runs everything but a sweep
that is given a filename.

Parity: the squirmer app's results store (``save_data``/``load_data``,
``examples/squirmer-axisymmetric.py:595-614``) and its resumable sweeps
(``main()`` skips labels already in the file, ``:809-813,842-846``).
Generalized: any solution vector + scalar attrs, keyed by a formatted
parameter label.
"""

from __future__ import annotations

import numpy as np


def param_label(**params) -> str:
    """Canonical dataset label, e.g. ``Re=1.00e+00,beta=1.00e+00``.

    Format parity with the reference's ``"Re={:.2e},beta={:.2e}"`` keys
    (``examples/squirmer-axisymmetric.py:604``).
    """
    return ",".join(f"{k}={float(v):.2e}" for k, v in params.items())


def save_solution(f, label: str, soln_vec, **attrs) -> None:
    """Store a solution vector under ``label`` with scalar attributes.

    ``f``: an open ``h5py.File`` (or group).  Overwrites existing labels.
    """
    if label in f:
        del f[label]
    dset = f.create_dataset(label, data=np.asarray(soln_vec))
    for k, v in attrs.items():
        dset.attrs[k] = v


def load_solution(f, label: str):
    """Return ``(soln_vec, attrs_dict)`` for a stored label."""
    dset = f[label]
    return dset[:], dict(dset.attrs)


def has_solution(f, label: str) -> bool:
    return f is not None and label in f


def open_results(filename: str | None, mode: str = "a"):
    """Open (or create) a results file; None -> no persistence."""
    if filename is None:
        return None
    import h5py

    return h5py.File(filename, mode)
