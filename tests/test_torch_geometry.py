"""Parity of the port's SE(2) geometry and angle utilities with the JAX
package, f64 on the CPU, on poses drawn from a numpy seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustrobotics_tpu.geometry import se2 as jse2
from rustrobotics_tpu.utils import angles as jangles
from rustrobotics_tpu_torch.geometry import se2 as tse2
from rustrobotics_tpu_torch.utils import angles as tangles

ATOL = 1e-12


def _poses(seed, n=64):
    rng = np.random.default_rng(seed)
    p = rng.normal(scale=3.0, size=(n, 3))
    p[:, 2] = rng.uniform(-3 * np.pi, 3 * np.pi, size=n)
    return p


@pytest.mark.parametrize("fn", ["compose", "relative"])
@pytest.mark.parametrize("seed", [0, 1])
def test_binary_pose_ops(fn, seed):
    a, b = _poses(seed), _poses(seed + 10)
    want = np.asarray(getattr(jse2, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tse2, fn)(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fn", ["inverse", "rotmat"])
def test_unary_pose_ops(fn):
    a = _poses(2)
    arg = a if fn == "inverse" else a[:, 2]
    want = np.asarray(getattr(jse2, fn)(jnp.asarray(arg)))
    got = getattr(tse2, fn)(torch.as_tensor(arg)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_transform_and_retract():
    a = _poses(3)
    pts = np.random.default_rng(4).normal(size=(64, 2))
    delta = np.random.default_rng(5).normal(scale=0.5, size=(64, 3))
    np.testing.assert_allclose(
        tse2.transform(torch.as_tensor(a), torch.as_tensor(pts)).numpy(),
        np.asarray(jse2.transform(jnp.asarray(a), jnp.asarray(pts))),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tse2.retract(torch.as_tensor(a), torch.as_tensor(delta)).numpy(),
        np.asarray(jse2.retract(jnp.asarray(a), jnp.asarray(delta))),
        atol=ATOL, rtol=0)


def test_angles():
    theta = np.random.default_rng(6).uniform(-20.0, 20.0, size=257)
    theta[:4] = [-np.pi, np.pi, 0.0, 3 * np.pi]
    np.testing.assert_allclose(
        tangles.wrap_angle(torch.as_tensor(theta)).numpy(),
        np.asarray(jangles.wrap_angle(jnp.asarray(theta))), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tangles.deg2rad(theta), jangles.deg2rad(theta))
    np.testing.assert_allclose(tangles.rad2deg(theta), jangles.rad2deg(theta))
