"""The port's parallel (associative-scan) Kalman filter and RTS smoother
against the JAX package's and against the sequential oracles, f64 on the
CPU (rtol 1e-9), and its associative scan against ``lax.associative_scan``
(the same tree of combines)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.localization import kalman_scan as jks
from rustrobotics_tpu_torch.localization import kalman_scan as tks

RTOL, ATOL = 1e-9, 1e-12


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _system(seed, steps):
    f = np.array([[1.0, 0.1], [0.0, 1.0]])
    h = np.array([[1.0, 0.0]])
    q = np.array([[0.01, 0.0], [0.0, 0.02]])
    r = np.array([[0.5]])
    ys = np.random.default_rng(seed).normal(size=(steps, 1))
    return f, q, h, r, np.array([0.0, 0.5]), np.eye(2), ys


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 7, 16, 37])
def test_associative_scan_same_tree_as_lax(n, reverse):
    """A combine that is neither commutative nor associative, in exact
    integers (3x + y): equal outputs mean the same tree of combines, so
    f32 sums associate as the JAX package's do."""
    rng = np.random.default_rng(n)
    a = rng.integers(-9, 9, (n, 2))

    def fn(x, y):
        return (3 * x[0] + y[0],)

    want = jax.lax.associative_scan(fn, (jnp.asarray(a),), reverse=reverse)
    got = tks.associative_scan(fn, (torch.tensor(a),), reverse=reverse)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("name", ["parallel_linear_kalman_filter",
                                  "sequential_linear_kalman_filter",
                                  "parallel_rts_smoother",
                                  "sequential_rts_smoother"])
def test_filter_and_smoother_match_jax(name):
    """T = 37: odd and even levels of the recursion."""
    args = _system(1, 37)
    jargs = tuple(map(jnp.asarray, args))
    targs = tuple(map(t, args))
    want = jax.jit(getattr(jks, name))(*jargs)
    got = getattr(tks, name)(*targs)
    close(got.x, want.x)
    close(got.cov, want.cov)


def test_parallel_matches_sequential():
    """The port's parallel filter and smoother against its sequential
    oracles at T = 257 (the JAX package's test, atol 1e-8)."""
    args = tuple(map(t, _system(2, 257)))
    par = tks.parallel_linear_kalman_filter(*args)
    seq = tks.sequential_linear_kalman_filter(*args)
    close(par.x, seq.x.numpy(), 0, 1e-8)
    close(par.cov, seq.cov.numpy(), 0, 1e-8)
    spar = tks.parallel_rts_smoother(*args)
    sseq = tks.sequential_rts_smoother(*args)
    close(spar.x, sseq.x.numpy(), 0, 1e-8)
    close(spar.cov, sseq.cov.numpy(), 0, 1e-8)
    # smoothing is not a no-op, and ends on the filtered posterior
    assert not np.allclose(spar.x[:-1].numpy(), seq.x[:-1].numpy())
    close(spar.x[-1], seq.x[-1].numpy(), 0, 1e-8)
