"""Diagnostics output (port of ``mgroms_tpu/io``)."""

from .diagnostics import read_field, write_field  # noqa: F401
