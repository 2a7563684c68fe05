"""Paths of the committed data files the port reads.

The port reads (never writes) the data files that ship with the JAX
package under ``archnemesis_tpu/data/``: the analytic CIA band tables and
the reference CIA ``.tab`` tables. This is a file read by path, not an
import of that package.
"""

import os

DATA_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "archnemesis_tpu", "data",
)


def data_file(*parts: str) -> str:
    """Path of one committed data file, e.g. ``data_file("assets",
    "cia_bands.npz")``; raises if it is absent."""
    path = os.path.join(DATA_ROOT, *parts)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return path
