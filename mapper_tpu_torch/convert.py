"""State carried across from the JAX package as plain data.

The port keeps its own copies of the JAX package's host classes, so an
object of one package is not handed to the other.  What crosses is plain
values and numpy arrays, turned here into the port's own objects.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mapper_tpu_torch.align.params import AlignmentParameters


def _plain(value):
    """A numpy scalar as its Python value; anything else as it is."""
    return value.item() if isinstance(value, np.generic) else value


def parameters_from_reference(fields) -> AlignmentParameters:
    """The port's AlignmentParameters from the JAX package's fields, a
    mapping of field names to plain values or numpy scalars (for example
    `dataclasses.asdict(params)` of the JAX package's parameters).  Names
    that start with `_` (cached tables) are dropped: the port's object
    rebuilds them.  Raises ValueError on a missing or unknown field."""
    names = {f.name for f in dataclasses.fields(AlignmentParameters)}
    given = {k: v for k, v in fields.items() if not k.startswith("_")}
    if given.keys() != names:
        missing, unknown = sorted(names - given.keys()), sorted(given.keys() - names)
        raise ValueError(f"parameter fields: missing {missing}, unknown {unknown}")
    return AlignmentParameters(**{k: _plain(v) for k, v in given.items()})
