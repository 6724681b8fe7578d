"""Random, well-conditioned Riccati problems for the sweep's tests (numpy
only, so the card-only tests can use it without JAX)."""
import numpy as np


def riccati_problem(rng, nx, nv, H, Bm, const, non_pd=None):
    """A problem built as tests/test_riccati_strategy.py builds them;
    ``const`` gives unbatched (n, m) cost blocks, ``non_pd`` = (problem,
    knot) a negative definite luu there.  Returns numpy (A, B, lx, lu, lxx,
    luu, lux, lfx, lfxx, reg)."""
    sym = lambda M: 0.5 * (M + np.swapaxes(M, -1, -2))
    rnd = lambda *s: rng.standard_normal(s)
    A = 0.1 * rnd(Bm, H, nx, nx) + np.eye(nx)
    Bmat = 0.1 * rnd(Bm, H, nx, nv)
    lx, lu = rnd(Bm, H, nx), rnd(Bm, H, nv)
    lfx = rnd(Bm, nx)
    lfxx = sym(np.eye(nx) + 0.1 * rnd(Bm, nx, nx))
    lfxx = lfxx @ np.swapaxes(lfxx, -1, -2)
    reg = rng.uniform(1e-6, 1e-2, Bm)
    lead = () if const else (Bm, H)
    lxx = sym(0.05 * rnd(*lead, nx, nx)) + 2.0 * np.eye(nx)
    luu = sym(0.05 * rnd(*lead, nv, nv)) + 2.0 * np.eye(nv)
    lux = 0.05 * rnd(*lead, nv, nx)
    if non_pd is not None:
        luu[non_pd] = -5.0 * np.eye(nv)
    return (A, Bmat, lx, lu, lxx, luu, lux, lfx, lfxx, reg)
