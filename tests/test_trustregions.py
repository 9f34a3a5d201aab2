"""RTR + tCG core: solve small known problems to high accuracy.

The dominant-eigenvector Rayleigh problem on the sphere and a PSD
quadratic on the Euclidean factory both have closed-form optima, which
exercises the exact tCG semantics (boundary tau, kappa/theta tests,
model-decrease guard) end to end."""

import jax
import jax.numpy as jnp
import numpy as np

from manisdp.core import Problem, TROptions, make_trustregions
from manisdp.manifolds import Euclidean, Sphere


def test_rayleigh_quotient_sphere():
    """min x' A x on the unit sphere -> smallest eigenvalue of A."""
    rng = np.random.default_rng(0)
    n = 40
    B = rng.standard_normal((n, n))
    A = jnp.asarray(B + B.T)

    def cost(Y, params):
        AY = Y @ params
        f = jnp.sum(AY * Y)
        return f, (AY,)

    def grad(Y, params, aux):
        (AY,) = aux
        # Riemannian grad: project 2AY
        return Sphere.proj(Y, 2.0 * AY), ()

    def hess(Y, U, params, aux, gaux):
        (AY,) = aux
        # Riemannian Hessian of the Rayleigh quotient
        H = 2.0 * (U @ params) - 2.0 * jnp.sum(Y * AY) * U
        return Sphere.proj(Y, H)

    problem = Problem(manifold=Sphere, cost=cost, grad=grad, hess=hess)
    opts = TROptions(maxiter=100, maxinner=40, tolgradnorm=1e-10)
    solve = jax.jit(make_trustregions(problem, opts))

    Y0 = Sphere.rand(jax.random.PRNGKey(1), 1, n)
    res = solve(Y0, A, jnp.pi)
    lam_min = float(np.linalg.eigvalsh(np.asarray(A))[0])
    assert float(res.norm_grad) < 1e-9
    np.testing.assert_allclose(float(res.fx), lam_min, rtol=1e-9)


def test_quadratic_euclidean():
    """min ||Y - T||^2 over R^{p x n} converges to T."""
    rng = np.random.default_rng(1)
    p, n = 2, 13
    T = jnp.asarray(rng.standard_normal((p, n)))

    def cost(Y, params):
        d = Y - params
        return jnp.sum(d * d), (d,)

    def grad(Y, params, aux):
        (d,) = aux
        return 2.0 * d, ()

    def hess(Y, U, params, aux, gaux):
        return 2.0 * U

    problem = Problem(manifold=Euclidean, cost=cost, grad=grad, hess=hess)
    opts = TROptions(maxiter=50, maxinner=30, tolgradnorm=1e-12)
    solve = jax.jit(make_trustregions(problem, opts))

    Y0 = jnp.zeros((p, n))
    res = solve(Y0, T, Euclidean.typicaldist(p, n))
    np.testing.assert_allclose(np.asarray(res.Y), np.asarray(T), atol=1e-10)


def test_stops_on_tolgradnorm_immediately():
    """If the initial gradient already meets the tolerance, no TR
    iterations run (stoppingcriterion.m check happens before iter 1)."""

    def cost(Y, params):
        return jnp.float64(0.0), ()

    def grad(Y, params, aux):
        return jnp.zeros_like(Y), ()

    def hess(Y, U, params, aux, gaux):
        return jnp.zeros_like(U)

    problem = Problem(manifold=Euclidean, cost=cost, grad=grad, hess=hess)
    solve = jax.jit(make_trustregions(problem, TROptions(maxiter=10)))
    res = solve(jnp.ones((2, 3)), None, jnp.float64(1.0))
    assert int(res.iters) == 0
    assert int(res.inner_iters) == 0
