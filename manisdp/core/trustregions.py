"""Riemannian trust-region solver with truncated CG — functional core.

Re-designs the exercised subset of Manopt's RTR
(manopt7.0/manopt/solvers/trustregions/trustregions.m and tCG.m) as one
jit-compiled function: the outer TR loop and the inner Steihaug-Toint
truncated-CG loop are both ``lax.while_loop``s, so a full inner solve is
a single XLA computation with no host round-trips — the property that
makes the tCG Hessian-product hot loop (tCG.m:163) run at device speed.

Semantics preserved exactly (verified against the MATLAB source):
  - Delta_bar = typicaldist, Delta0 = Delta_bar/8 (trustregions.m:363-372)
  - tCG stop codes 1-6: negative curvature / TR boundary (exact tau,
    tCG.m:188) / kappa target / theta target / maxinner / model increase
    (tCG.m:183-257)
  - per-iteration re-projection of the search direction (tCG.m:283)
  - rho regularization max(1,|fx|)*eps*1e3 (trustregions.m:579-581)
  - accept iff model decreased and rho > rho_prime = 0.1 (:688)
  - Delta/4 on rho<1/4 or model increase; min(2*Delta, Delta_bar) on
    rho>3/4 with boundary/neg-curvature stop (:653-679)
  - stop on gradnorm < tolgradnorm or k >= maxiter (stoppingcriterion.m)

useRand stays false (ManiSDP never enables it) and the preconditioner is
the identity, as in the reference configuration.

The solver is dtype-generic: all scalar state follows the dtype of the
initial point, so the same factory serves the f64 path and the f32
stage of the mixed-precision inner solve (cast Y/params to float32,
solve to a loose tolgradnorm, then refine in f64 — SURVEY §7's
accuracy/speed option).
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .problem import Problem, TROptions, TRResult


class _TCGState(NamedTuple):
    eta: Any
    Heta: Any
    r: Any
    mdelta: Any
    e_Pe: Any
    e_Pd: Any
    d_Pd: Any
    z_r: Any
    model_value: Any
    j: Any            # completed tCG iterations (Hessian calls)
    stop: Any         # 0 = keep going; 1..6 = tCG.m stop codes


def _make_tcg(problem: Problem, opts: TROptions):
    M = problem.manifold
    inner = M.inner
    tcg_dt = jnp.dtype(opts.tcg_dtype) if opts.tcg_dtype else None

    def _cast(tree, dt):
        return jax.tree_util.tree_map(
            lambda x: x.astype(dt)
            if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
            else x, tree)

    def tcg(Y, grad, Delta, params, aux, gaux):
        out_dt = Y.dtype
        if tcg_dt is not None and tcg_dt != out_dt:
            # inexact-Newton model solve: the whole CG loop (and every
            # Hessian-vector product) runs in tcg_dtype; the caller's
            # cost/grad/rho stay in the ambient dtype
            Y, grad, params, aux, gaux = (
                _cast(Y, tcg_dt), _cast(grad, tcg_dt), _cast(params, tcg_dt),
                _cast(aux, tcg_dt), _cast(gaux, tcg_dt))
            Delta = Delta.astype(tcg_dt)
        Heta0 = M.zerovec(Y)
        r0 = grad
        r_r0 = inner(Y, r0, r0)
        norm_r0 = jnp.sqrt(r_r0)
        # no preconditioner: z = r
        kappa_bound = norm_r0 * jnp.minimum(norm_r0 ** opts.theta, opts.kappa)
        if tcg_dt is not None:
            # the reduced precision cannot reach relative residuals
            # below its floor; clamp the target instead of stalling
            kappa_bound = jnp.maximum(
                kappa_bound, norm_r0 * opts.tcg_resid_floor)
        linear = opts.kappa < norm_r0 ** opts.theta  # stop-code 3 vs 4

        zero = jnp.zeros((), dtype=r_r0.dtype)
        init = _TCGState(
            eta=M.zerovec(Y), Heta=Heta0, r=r0, mdelta=r0,
            e_Pe=zero, e_Pd=zero, d_Pd=r_r0,
            z_r=r_r0, model_value=zero,
            j=jnp.int32(0), stop=jnp.int32(0))

        def cond(s: _TCGState):
            return (s.stop == 0) & (s.j < opts.maxinner)

        def body(s: _TCGState):
            Hmdelta = problem.hess(Y, s.mdelta, params, aux, gaux)
            d_Hd = inner(Y, s.mdelta, Hmdelta)
            d_r = inner(Y, s.mdelta, s.r)
            alpha = s.z_r / d_Hd
            e_Pe_new = s.e_Pe + 2.0 * alpha * s.e_Pd + alpha * alpha * s.d_Pd

            boundary = (d_Hd <= 0.0) | (e_Pe_new >= Delta * Delta)
            # exact boundary solve (tCG.m:188)
            tau = (-s.e_Pd + jnp.sqrt(
                s.e_Pd * s.e_Pd + s.d_Pd * (Delta * Delta - s.e_Pe))
            ) / s.d_Pd
            step = jnp.where(boundary, tau, alpha)

            new_eta = s.eta - step * s.mdelta
            new_Heta = s.Heta - step * Hmdelta
            # incremental model value: m(eta - t d) = m(eta) - t<d, r>
            # + t^2/2 <d, Hd> with r = grad of the model at eta
            # (maintained by the CG recurrence).  Replaces the
            # reference's two full-array inner products per iteration
            # (tCG.m:223-226) with scalars already in registers — the
            # guard's purpose (detect numerical breakdown, stop 6) is
            # preserved since drift of the recurrence IS the breakdown
            # being detected.
            new_mv = s.model_value - step * d_r + \
                0.5 * step * step * d_Hd
            model_inc = (~boundary) & (new_mv >= s.model_value)

            stop = jnp.where(
                boundary,
                jnp.where(d_Hd <= 0.0, jnp.int32(1), jnp.int32(2)),
                jnp.where(model_inc, jnp.int32(6), jnp.int32(0)))

            # on model increase (stop 6) return the PREVIOUS iterate
            keep_prev = model_inc
            eta = jnp.where(keep_prev, s.eta, new_eta)
            Heta = jnp.where(keep_prev, s.Heta, new_Heta)
            model_value = jnp.where(keep_prev, s.model_value, new_mv)

            r = s.r - alpha * Hmdelta
            r_r = inner(Y, r, r)
            norm_r = jnp.sqrt(r_r)
            hit_kappa = (stop == 0) & (s.j + 1 >= opts.mininner) & \
                (norm_r <= kappa_bound)
            stop = jnp.where(
                hit_kappa,
                jnp.where(linear, jnp.int32(3), jnp.int32(4)),
                stop)

            beta = r_r / s.z_r
            mdelta = M.tangent(Y, r + beta * s.mdelta)
            e_Pd = beta * (s.e_Pd + alpha * s.d_Pd)
            d_Pd = r_r + beta * beta * s.d_Pd

            return _TCGState(
                eta=eta, Heta=Heta, r=r, mdelta=mdelta,
                e_Pe=jnp.where(boundary, s.e_Pe, e_Pe_new),
                e_Pd=e_Pd, d_Pd=d_Pd, z_r=r_r, model_value=model_value,
                j=s.j + 1, stop=stop)

        final = lax.while_loop(cond, body, init)
        stop = jnp.where(final.stop == 0, jnp.int32(5), final.stop)
        eta, Heta = final.eta, final.Heta
        if tcg_dt is not None and tcg_dt != out_dt:
            eta = eta.astype(out_dt)
            Heta = Heta.astype(out_dt)
        return eta, Heta, final.j, stop

    return tcg


class _TRState(NamedTuple):
    Y: Any
    fx: Any
    g: Any
    aux: Any
    gaux: Any
    norm_grad: Any
    Delta: Any
    k: Any
    total_inner: Any


def make_trustregions(problem: Problem, opts: TROptions):
    """Build the jittable RTR solve: (Y0, params, typicaldist) -> TRResult.

    ``typicaldist`` is a runtime scalar so Euclidean factories (whose
    typical distance depends on the active rank) do not force recompiles.
    """
    M = problem.manifold
    tcg = _make_tcg(problem, opts)

    def solve(Y0, params, typicaldist):
        # keep every scalar in Y0's dtype so an f32 point yields a pure
        # f32 program (a dtype-equal convert traces to a no-op, so the
        # f64 path's compiled HLO is unchanged)
        Delta_bar = jnp.asarray(typicaldist, dtype=Y0.dtype)
        Delta0 = Delta_bar / 8.0
        eps = jnp.finfo(Y0.dtype).eps

        f0, aux0 = problem.cost(Y0, params)
        g0, gaux0 = problem.grad(Y0, params, aux0)
        norm_g0 = M.norm(Y0, g0)

        init = _TRState(Y=Y0, fx=f0, g=g0, aux=aux0, gaux=gaux0,
                        norm_grad=norm_g0, Delta=Delta0,
                        k=jnp.int32(0), total_inner=jnp.int32(0))

        def cond(s: _TRState):
            return (s.k < opts.maxiter) & (s.norm_grad >= opts.tolgradnorm)

        def body(s: _TRState):
            eta, Heta, numit, stop_inner = tcg(
                s.Y, s.g, s.Delta, params, s.aux, s.gaux)

            Y_prop = M.retr(s.Y, eta)
            f_prop, aux_prop = problem.cost(Y_prop, params)

            rho_reg = jnp.maximum(1.0, jnp.abs(s.fx)) * eps * \
                opts.rho_regularization
            rhonum = s.fx - f_prop + rho_reg
            vecrho = s.g + 0.5 * Heta
            rhoden = -M.inner(s.Y, eta, vecrho) + rho_reg
            model_decreased = rhoden >= 0.0
            rho = rhonum / rhoden

            shrink = (rho < 0.25) | (~model_decreased) | jnp.isnan(rho)
            grow = (rho > 0.75) & ((stop_inner == 1) | (stop_inner == 2))
            Delta = jnp.where(
                shrink, s.Delta / 4.0,
                jnp.where(grow, jnp.minimum(2.0 * s.Delta, Delta_bar),
                          s.Delta))

            accept = model_decreased & (rho > opts.rho_prime)

            def on_accept(_):
                g_new, gaux_new = problem.grad(Y_prop, params, aux_prop)
                return (Y_prop, f_prop, g_new, aux_prop, gaux_new,
                        M.norm(Y_prop, g_new))

            def on_reject(_):
                return (s.Y, s.fx, s.g, s.aux, s.gaux, s.norm_grad)

            Y, fx, g, aux, gaux, norm_grad = lax.cond(
                accept, on_accept, on_reject, operand=None)

            return _TRState(Y=Y, fx=fx, g=g, aux=aux, gaux=gaux,
                            norm_grad=norm_grad, Delta=Delta, k=s.k + 1,
                            total_inner=s.total_inner + numit)

        final = lax.while_loop(cond, body, init)
        return TRResult(Y=final.Y, fx=final.fx, norm_grad=final.norm_grad,
                        iters=final.k, inner_iters=final.total_inner)

    return solve
