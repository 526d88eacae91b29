"""The case fields a configuration names (its ``case`` key), made by the
benchmark and handed alike to the program and to the reference.  A case
is a module of this package, found by that name: its
``build(conf, nx, ny)`` returns a :class:`Case` of numpy float64
interior (ny, nx) fields from the configuration's keys."""

from __future__ import annotations

import importlib
from typing import NamedTuple

import numpy as np


class Case(NamedTuple):
    dx: np.ndarray
    dy: np.ndarray
    zeta: np.ndarray
    h: np.ndarray
    hc: float
    theta_b: float
    theta_s: float


def build(conf: dict, nx: int, ny: int) -> Case:
    """The case a configuration names, at (nx, ny)."""
    return importlib.import_module(f"{__name__}.{conf['case']}").build(
        conf, nx, ny)
