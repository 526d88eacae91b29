"""Port ops == JAX ops in float64 at 16^3 (same inputs from numpy).

Tolerance: 1e-12 x max|JAX| — both run the same term order in f64 on the
CPU, so only contraction / reordering noise is left.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgroms_tpu import bc as jbc
from mgroms_tpu.ops import relax as jrelax
from mgroms_tpu.ops import stencil as jstencil
from mgroms_tpu.ops import transfer as jtransfer
from mgroms_tpu_torch import bc as tbc
from mgroms_tpu_torch.ops import relax as trelax
from mgroms_tpu_torch.ops import stencil as tstencil
from mgroms_tpu_torch.ops import transfer as ttransfer

torch.set_num_threads(1)

NZ, NY, NX = 16, 16, 16


def close(got, want, tol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def problem(seed, nz=NZ, ny=NY, nx=NX):
    rng = np.random.default_rng(seed)
    cA = rng.uniform(-0.1, 0.1, (8, nz, ny + 2, nx + 2))
    cA[0] -= 4.0
    p = rng.standard_normal((nz, ny, nx))
    b = rng.standard_normal((nz, ny, nx))
    return cA, p, b


def both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def test_extend_h1_h2():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 7, 9))
    (ja,), (ta,) = both(a)
    close(tbc.extend_h1(ta), jbc.extend_h1(ja), 0)
    close(tbc.extend_h2(ta), jbc.extend_h2(ja))
    m = rng.uniform(0, 1, (7, 9)).round()
    (jm,), (tm,) = both(m)
    for bmask in (True, False):
        close(tbc.extend_rmask(tm, bmask), jbc.extend_rmask(jm, bmask), 0)


@pytest.mark.parametrize("real", [True, False])
def test_residual(real):
    cA, p, b = problem(1)
    (jc, jp, jb), (tc, tp, tb) = both(cA, p, b)
    close(tstencil.residual(tbc.extend_h1(tp), tb, tc, real),
          jstencil.residual(jbc.extend_h1(jp), jb, jc, real))


def test_masked_relax():
    cA, p, b = problem(2)
    (jc, jp, jb), (tc, tp, tb) = both(cA, p, b)
    want = jrelax.relax(jp, jb, jc, 3, "RB", True, extend_fn=jbc.extend_h1)
    got = trelax.relax(tp, tb, tc, 3, "RB", True, extend_fn=tbc.extend_h1)
    close(got, want)
    with pytest.raises(ValueError, match="unknown relax kind"):
        trelax.relax(tp, tb, tc, 1, "XY", True, extend_fn=tbc.extend_h1)


@pytest.mark.parametrize("origin", [(0, 0), (1, 2)])
@pytest.mark.parametrize("kind", ["FC", "GS"])
def test_masked_relax_orderings(kind, origin):
    """The four-colour and column-Jacobi GS orderings, with a tile origin
    that shifts the colouring, against JAX's masked relax."""
    cA, p, b = problem(6)
    (jc, jp, jb), (tc, tp, tb) = both(cA, p, b)
    j0, i0 = origin
    for real in (True, False):
        want = jrelax.relax(jp, jb, jc, 3, kind, real,
                            extend_fn=jbc.extend_h1, j0=j0, i0=i0)
        got = trelax.relax(tp, tb, tc, 3, kind, real,
                           extend_fn=tbc.extend_h1, j0=j0, i0=i0)
        close(got, want)


@pytest.mark.parametrize("nz", [1, 2, 16])
def test_thomas_family(nz):
    rng = np.random.default_rng(3)
    d = rng.uniform(2.0, 3.0, (nz, 4, 8))
    ud = rng.uniform(-1.0, -0.5, (nz - 1, 4, 8))
    b = rng.standard_normal((nz, 4, 8))
    (jd, jud, jb), (td, tud, tb) = both(d, ud, b)
    jbet, jgam = jrelax.thomas_factor(jd, jud)
    tbet, tgam = trelax.thomas_factor(td, tud)
    close(tbet, jbet)
    close(tgam, jgam)
    close(trelax.tridiag(td, tud, tb), jrelax.tridiag(jd, jud, jb))
    close(trelax.tridiag_factored(tbet, tgam, tud, tb),
          jrelax.tridiag_factored(jbet, jgam, jud, jb))
    close(trelax.thomas_factored_unrolled(tbet, None, tud, tb),
          jrelax.thomas_factored_unrolled(jbet, None, jud, jb))


def test_restrict():
    _, p, _ = problem(4)
    (jp,), (tp,) = both(p)
    close(ttransfer.restrict(tp), jtransfer.restrict(jp), 0)


@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_prolong_full_and_quads(interp):
    rng = np.random.default_rng(5)
    xc = rng.standard_normal((NZ // 2, NY // 2 + 2, NX // 2 + 2))
    (jx,), (tx,) = both(xc)
    close(ttransfer.prolong(tx, NZ, interp), jtransfer.prolong(jx, NZ, interp))
    jq = jtransfer.prolong(jx, NZ, interp, as_quads=True)
    tq = ttransfer.prolong(tx, NZ, interp, as_quads=True)
    assert sorted(tq) == sorted(jq)
    for k in jq:
        close(tq[k], jq[k])
