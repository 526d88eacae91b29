"""The one traffic generator: reads a mix's data file (``traffic/<mix>.json``)
and makes its inputs on the device from the run's seed.

A mix of kind ``closed_loop_steps`` is a host ocean model calling the
solve once a baroclinic time step and waiting for it before the next: one
caller, a closed loop, no arrival rate.  Its inputs are a pool of
``pool`` velocity fields (u, v, w), used in turn.  Each field is the
field of the reference's test programs (u = v = 0, w = -1 but at the
bottom face, where w = 0; mg_testseamount.f90:119-123) plus, on each
component, a sum of
``patches.count`` Gaussian blobs with amplitudes uniform in
``patches.amplitude`` and relative widths uniform in ``patches.width``,
centred uniformly in the unit cube (the recipe of the reference's
``setup_random_patches``, mg_define_rhs.f90:97-163, on the staggered
points of each component).  The patches are an assumption, stated in
the mix's ``assumed``: no source gives a host model's step-to-step change.

A blob is separable, so a component's sum is one product of a
(z, blob) by a (blob, y x) matrix: a few large calls a field, on the
device, in the program's type.  Every seed gives the same sizes; only the
draws differ.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def load(mix: str) -> dict:
    """The mix's parameters, from ``traffic/<mix>.json``."""
    return json.loads((HERE / "traffic" / f"{mix}.json").read_text())


def _axis(n: int, faces: bool, dtype, device) -> torch.Tensor:
    """Unit-interval coordinates of a horizontal axis with its halo: the n+1
    faces 0..n, or the n+2 centres of cells 0..n+1 (halo cells outside)."""
    i = torch.arange(n + 1 if faces else n + 2, dtype=dtype, device=device)
    return i / n if faces else (i - 0.5) / n


def _patches(g: torch.Generator, spec: dict, z, y, x) -> torch.Tensor:
    """The blob sum on the grid z (nzc,) x y (J,) x x (I,); z is the
    depth below the surface as a fraction of the column."""
    k = spec["count"]
    dev, dt = x.device, x.dtype

    def draw(*shape):
        return torch.rand(shape, generator=g, device=dev, dtype=torch.float64)

    c = draw(k, 3)
    lo, hi = spec["amplitude"]
    amp = lo + (hi - lo) * draw(k)
    lo, hi = spec["width"]
    wid = lo + (hi - lo) * draw(k)
    c, amp, wid = c.to(dt), amp.to(dt), wid.to(dt)
    ex = torch.exp(-((x[None, :] - c[:, 0:1]) / wid[:, None]) ** 2)
    ey = torch.exp(-((y[None, :] - c[:, 1:2]) / wid[:, None]) ** 2)
    ez = amp[:, None] * torch.exp(-((z[None, :] - c[:, 2:3])
                                    / wid[:, None]) ** 2)
    yx = (ey[:, :, None] * ex[:, None, :]).reshape(k, -1)
    return (ez.T @ yx).reshape(z.numel(), y.numel(), x.numel())


def make_pool(spec: dict, nx: int, ny: int, nz: int, seed: int, dtype,
              device) -> list:
    """``spec['pool']`` fields (u, v, w) of a ``closed_loop_steps`` mix,
    drawn from ``seed``."""
    if spec["kind"] != "closed_loop_steps":
        raise ValueError(f"unknown traffic kind {spec['kind']!r}")
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    ax = lambda n, faces: _axis(n, faces, dtype, device)
    kr = (torch.arange(nz, dtype=dtype, device=device) + 0.5) / nz
    kw = torch.arange(nz + 1, dtype=dtype, device=device) / nz
    depth_r, depth_w = 1.0 - kr, 1.0 - kw
    pool = []
    for _ in range(spec["pool"]):
        u = _patches(g, spec["patches"], depth_r, ax(ny, False), ax(nx, True))
        v = _patches(g, spec["patches"], depth_r, ax(ny, True), ax(nx, False))
        w = _patches(g, spec["patches"], depth_w, ax(ny, False),
                     ax(nx, False)) - 1.0
        w[0] = 0.0
        pool.append((u, v, w))
    return pool
