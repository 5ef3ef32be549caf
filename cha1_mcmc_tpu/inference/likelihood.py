"""Likelihood and posterior log-probability builders (jittable).

The reference evaluates lnprob one walker at a time in forked CPU worker
processes (reference inference.py:239-246, 456-463). Here `build_lnprob`
returns a pure scalar function of theta; callers vmap it over walkers and
jit the result — one fused device program per ensemble half-step.

Failure semantics: the reference converts exceptions and non-finite values
to -inf so the sampler rejects the proposal (reference inference.py:145-147,
153-155, 162-164, 241-245). Under jit there are no exceptions; the same
effect is obtained by mapping non-finite lnlike values to -inf.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cha1_mcmc_tpu.models.forward import SpectralModel
from cha1_mcmc_tpu.ops.lte import planck_J, beam_dilution, tau_sticks
from cha1_mcmc_tpu.inference.params import ParamSpec

__all__ = ["build_lnlike", "build_lnprob", "build_lnprob_batched",
           "build_lnlike_batched", "batched_model_gather",
           "batched_model_gather_split"]


def _rt_tail(opac, ss, Tex, grid_freq, dish_size, Tbg, dtype):
    """Radiative transfer + beam dilution over per-component opacity
    (reference inference.py:54-60): (N, K, C) opacity -> (N, C) model.
    -expm1(-tau) is the reference's 1 - exp(-tau) without the f32
    cancellation at small opacity (optically thin lines)."""
    J_T = planck_J(jnp, grid_freq, Tex[:, None, None], guard=1e-10)
    J_Tbg = planck_J(jnp, grid_freq, jnp.asarray(Tbg, dtype=dtype), guard=1e-10)
    dil = beam_dilution(jnp, grid_freq, ss[..., None], dish_size)
    return jnp.sum(dil * (J_T - J_Tbg) * -jnp.expm1(-opac), axis=1)


def _batched_opacity_model(opacity_fn, line_freq, line_elower, line_aij,
                           line_gup, line_glow, q_model, grid_freq,
                           dish_size, Tbg, dtype, spec, thetas,
                           axis_name: str | None = None):
    """Shared walker-batched body for every opacity formulation: unpack
    theta, per-line stick opacities, the formulation-specific opacity
    (`opacity_fn` over the (N*K)-flattened taus/vlsr/dV), an optional
    cross-shard psum, then the radiative-transfer tail. The line arrays
    may be a device-local shard or the active subset a gather-table
    builder selected — whatever `opacity_fn` was built against."""
    thetas = jnp.asarray(thetas, dtype=dtype)
    N = thetas.shape[0]
    K = spec.ncomp
    ss, Ncol, Tex, vlsr, dV = spec.unpack(thetas)
    Q = q_model(Tex)
    taus = tau_sticks(jnp, line_freq, line_elower, line_aij, line_gup,
                      line_glow, Q[:, None, None], Ncol[..., None],
                      Tex[:, None, None], dV[:, None, None])      # (N, K, L)
    opac = opacity_fn(
        taus.reshape(N * K, -1), vlsr.reshape(N * K),
        jnp.broadcast_to(dV[:, None], (N, K)).reshape(N * K)
    ).reshape(N, K, -1)
    if axis_name is not None:
        opac = jax.lax.psum(opac, axis_name)
    return _rt_tail(opac, ss, Tex, grid_freq, dish_size, Tbg, dtype)


def batched_model_gather(line_freq, line_elower, line_aij, line_gup,
                         line_glow, q_model, grid_freq, mask_center,
                         dish_size, Tbg, dtype, spec, thetas, line_table,
                         vel_t):
    """(N, C) walker-batched forward model via the channel-major gather
    opacity (models/opacity.py:opacity_gather) — fastest when the ±10·dV
    window is element-sparse (dense catalogs on coarse grids). The line
    arrays here are the *active subset* selected by build_opacity_gather;
    taus are computed only for those."""
    from cha1_mcmc_tpu.models.opacity import opacity_gather

    return _batched_opacity_model(
        lambda t, v, d: opacity_gather(t, v, d, line_table, vel_t,
                                       mask_center=mask_center),
        line_freq, line_elower, line_aij, line_gup, line_glow, q_model,
        grid_freq, dish_size, Tbg, dtype, spec, thetas)


def batched_model_gather_split(line_freq, line_elower, line_aij, line_gup,
                               line_glow, q_model, grid_freq, mask_center,
                               dish_size, Tbg, dtype, spec, thetas,
                               split_tables):
    """(N, C) walker-batched forward model via the two-class split gather
    (models/opacity.py:opacity_gather_split) — same semantics as
    batched_model_gather, but the per-channel line table is split into a
    short every-channel table plus a heavy-channel overflow table, cutting
    the rectangular padding waste (~95% of the (M, C) element work on
    1-cyanonaphthalene). The line arrays are the active subset from
    build_opacity_gather_split."""
    from cha1_mcmc_tpu.models.opacity import opacity_gather_split

    table1, vel1, table2, vel2, heavy_onehot = split_tables
    return _batched_opacity_model(
        lambda t, v, d: opacity_gather_split(
            t, v, d, table1, vel1, table2, vel2, heavy_onehot,
            mask_center=mask_center),
        line_freq, line_elower, line_aij, line_gup, line_glow, q_model,
        grid_freq, dish_size, Tbg, dtype, spec, thetas)


def build_lnlike(model: SpectralModel, spec: ParamSpec, grid_ints, grid_yerrs):
    """Scalar lnlike(theta) (reference inference.py:127-166).

    chi^2 form: -0.5 * sum[(y - m)^2 / sigma^2 - ln(1/sigma^2)].
    """
    y = jnp.asarray(grid_ints, dtype=model.dtype)
    yerrs = jnp.asarray(grid_yerrs, dtype=model.dtype)
    inv_sigma2 = 1.0 / (yerrs ** 2)

    def lnlike(theta):
        ss, Ncol, Tex, vlsr, dV = spec.unpack(jnp.asarray(theta, dtype=model.dtype))
        m = model.forward(ss, Ncol, Tex, vlsr, dV)
        ll = model.chi2_lnlike(m, y, inv_sigma2)
        # Non-finite model/likelihood -> reject (reference inference.py:162-164).
        return jnp.where(jnp.isfinite(ll), ll, -jnp.inf)

    return lnlike


def build_lnprob(model: SpectralModel, spec: ParamSpec, grid_ints, grid_yerrs, lnprior_fn):
    """Scalar lnprob(theta) = lnprior + lnlike (reference inference.py:239-246).

    -inf prior short-circuits in the reference; here both terms are computed
    (they are cheap and fused) and -inf propagates through the sum, with a
    guard so that -inf prior + NaN likelihood still yields -inf.
    """
    lnlike = build_lnlike(model, spec, grid_ints, grid_yerrs)

    def lnprob(theta):
        lp = lnprior_fn(theta)
        ll = lnlike(theta)
        total = lp + ll
        return jnp.where(jnp.isfinite(lp) & jnp.isfinite(ll), total, -jnp.inf)

    return lnprob


def _build_batched_model(model: SpectralModel, spec: ParamSpec, *,
                         use_pallas: bool = False,
                         dv_max: float | None = None):
    """Batched forward model builder, thetas (N, D) -> (N, C) — the shared
    machinery behind build_lnprob_batched and build_lnlike_batched.

    use_pallas=True selects the sparse channel-major gather opacity
    (models/opacity.py): the two-class split tables when their modeled
    element work beats the rectangular (M, C) table by >= 1.3x (skewed
    per-channel line counts on dense catalogs), else the plain table.
    Both keep the exact ±10·dV window for every dV <= dv_max; heavy
    channels of the split differ only by f32 reassociation. Otherwise the
    dense (N, K, L, C) einsum runs.
    """
    dtype = model.dtype
    C = model.n_channels

    if use_pallas:
        from cha1_mcmc_tpu.models.opacity import (
            build_opacity_gather, build_opacity_gather_split,
            heavy_scatter_onehot)

        if dv_max is None:
            raise ValueError("use_pallas=True requires dv_max (from prior bounds)")
        vel_grid = np.asarray(model.vel_grid)
        split = build_opacity_gather_split(vel_grid, model.mask_center, dv_max)
        if split is not None:
            t1, v1, t2, v2, heavy, g_active = split
            g_split = (jnp.asarray(t1), jnp.asarray(v1, dtype),
                       jnp.asarray(t2), jnp.asarray(v2, dtype),
                       jnp.asarray(heavy_scatter_onehot(heavy, C), dtype))
        else:
            g_table, g_vel, g_active = build_opacity_gather(
                vel_grid, model.mask_center, dv_max)
            g_table = jnp.asarray(g_table)
            g_vel = jnp.asarray(g_vel, dtype)
        g_lines = tuple(jnp.asarray(np.asarray(arr)[g_active])
                        for arr in (model.line_freq, model.line_elower,
                                    model.line_aij, model.line_gup,
                                    model.line_glow))

    from cha1_mcmc_tpu.constants import FWHM_TO_SIGMA_MODEL, VELOCITY_WINDOW_DV

    def model_batch(thetas):
        thetas = jnp.asarray(thetas, dtype=dtype)
        if use_pallas and split is not None:
            return batched_model_gather_split(
                *g_lines, model.q_model, model.grid_freq, model.mask_center,
                model.dish_size, model.Tbg, dtype, spec, thetas, g_split)
        if use_pallas:
            return batched_model_gather(
                *g_lines, model.q_model, model.grid_freq, model.mask_center,
                model.dish_size, model.Tbg, dtype, spec, thetas, g_table,
                g_vel)
        ss, Ncol, Tex, vlsr, dV = spec.unpack(thetas)  # ss (N,K), Tex (N,)
        Q = model.q_model(Tex)                          # (N,)
        taus = tau_sticks(
            jnp, model.line_freq, model.line_elower, model.line_aij,
            model.line_gup, model.line_glow,
            Q[:, None, None], Ncol[..., None], Tex[:, None, None],
            dV[:, None, None])                          # (N, K, L)
        sigma = (dV / FWHM_TO_SIGMA_MODEL)[:, None, None, None]
        window = (jnp.abs(model.vel_grid - model.mask_center)
                  < VELOCITY_WINDOW_DV * dV[:, None, None, None])
        z = (model.vel_grid - vlsr[..., None, None]) / sigma
        gauss = jnp.where(window, jnp.exp(-0.5 * z * z), 0.0)  # (N,K,L,C)
        opac = jnp.einsum("nkl,nklc->nkc", taus, gauss,
                          precision=jax.lax.Precision.HIGHEST)
        return _rt_tail(opac, ss, Tex, model.grid_freq, model.dish_size,
                        model.Tbg, dtype)

    return model_batch


def build_lnlike_batched(model: SpectralModel, spec: ParamSpec, grid_ints,
                         grid_yerrs, **kwargs):
    """Batched lnlike(thetas (N, D)) -> (N,).

    The chi^2 of build_lnlike over the batched forward model (same kwargs
    as build_lnprob_batched). Exists because the *scalar* lnlike closes
    over the (L, C) velocity grid — a ~290 MB constant baked into the
    program on the dense aromatic catalogs — while the gather-table path
    carries only the active-line tables. Used by the MLE Ncol initializer
    on dense fits (inference/mle.py).
    """
    dtype = model.dtype
    y = jnp.asarray(grid_ints, dtype=dtype)
    inv_sigma2 = 1.0 / jnp.asarray(grid_yerrs, dtype=dtype) ** 2
    model_batch = _build_batched_model(model, spec, **kwargs)

    def lnlike_batch(thetas):
        m = model_batch(thetas)
        resid = y - m
        ll = -0.5 * jnp.sum(resid * resid * inv_sigma2 - jnp.log(inv_sigma2),
                            axis=-1)
        return jnp.where(jnp.isfinite(ll), ll, -jnp.inf)

    return lnlike_batch


def build_lnprob_batched(model: SpectralModel, spec: ParamSpec, grid_ints,
                         grid_yerrs, lnprior_fn, *, use_pallas: bool = False,
                         dv_max: float | None = None):
    """Batched lnprob(thetas (N, D)) -> (N,).

    The vmapped scalar path (build_lnprob) materializes a (N, L, C) Gaussian
    intermediate; for dense catalogs that is bandwidth-bound or simply too
    large to compile. This builder keeps the walker batch explicit so the
    opacity accumulation can run through the sparse channel-major gather
    (use_pallas=True, models/opacity.py), which exploits the ±10·dV window
    sparsity.

    dv_max: upper bound on dV used for the *static* sparsity structure
    (take it from the prior box bounds); required when use_pallas=True.
    """
    dtype = model.dtype
    y = jnp.asarray(grid_ints, dtype=dtype)
    inv_sigma2 = 1.0 / jnp.asarray(grid_yerrs, dtype=dtype) ** 2
    model_batch = _build_batched_model(model, spec, use_pallas=use_pallas,
                                       dv_max=dv_max)

    def lnprob_batch(thetas):
        thetas = jnp.asarray(thetas, dtype=dtype)
        m = model_batch(thetas)
        resid = y - m
        ll = -0.5 * jnp.sum(resid * resid * inv_sigma2 - jnp.log(inv_sigma2), axis=-1)
        lp = jax.vmap(lnprior_fn)(thetas)
        return jnp.where(jnp.isfinite(lp) & jnp.isfinite(ll), lp + ll, -jnp.inf)

    return lnprob_batch
