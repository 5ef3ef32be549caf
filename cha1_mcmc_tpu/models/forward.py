"""Forward emission model.

Two layers:

* :func:`simulate_sticks_host` — host-side float64 stick simulation over the
  full (trimmed) catalog, equivalent to the reference's MolSim with
  gauss=False (reference spectral_simulator/classes.py:294-397). Used once
  per fit for data reduction / covered-line selection; never in the hot loop.

* :class:`SpectralModel` — the jitted device model. The reference rebuilds a
  MolSim object and re-runs the full catalog math on every likelihood call
  (reference inference.py:249-253), then loops per line over channels in a
  Numba kernel (reference inference.py:44-61). Here everything static —
  covered-line arrays, the (lines x channels) velocity grid, the background
  Planck term — is precomputed once; a likelihood evaluation is a handful of
  fused element-wise ops plus one contraction over the line axis (a batched
  matrix product when vmapped over walkers).

* :func:`forward_host` — the float64 NumPy oracle of the device model, for
  checking f32 device results.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from cha1_mcmc_tpu.constants import (
    CKM,
    H,
    K,
    T_CMB,
    FWHM_TO_SIGMA_MODEL,
    VELOCITY_WINDOW_DV,
)
from cha1_mcmc_tpu.ops.lte import planck_J, beam_dilution, tau_sticks, stick_spectrum
from cha1_mcmc_tpu.catalogs.spcat import Catalog
from cha1_mcmc_tpu.catalogs.partition import QModel, q_model_for_catalog


def simulate_sticks_host(
    catalog: Catalog,
    C,
    dV,
    T,
    ll,
    ul,
    source_size: float,
    dish_size: float,
    Tbg: float = T_CMB,
    q_model: QModel | None = None,
):
    """Stick simulation over the trimmed catalog, float64 NumPy.

    Equivalent to MolSim(..., gauss=False) (reference classes.py:294-397):
    per component, compute full-catalog opacities, trim to the [ll, ul]
    windows, convert to stick intensities with beam dilution, and sum the
    components (after radiative transfer, reference classes.py:394-395).
    In stick mode the vlsr shift has no effect on the returned arrays (the
    reference computes the shift but extends the unshifted intensities,
    reference classes.py:379-386), so no vlsr argument is taken.

    C, dV, T are per-component sequences; ll, ul per-chunk sequences.
    Returns (freq_sim, int_sim, tau_sim) with int/tau summed over components.
    """
    C = np.atleast_1d(np.asarray(C, dtype=np.float64))
    dV = np.atleast_1d(np.asarray(dV, dtype=np.float64))
    T = np.atleast_1d(np.asarray(T, dtype=np.float64))
    ll = np.atleast_1d(np.asarray(ll, dtype=np.float64))
    ul = np.atleast_1d(np.asarray(ul, dtype=np.float64))
    if q_model is None:
        q_model = q_model_for_catalog(catalog)

    chunks = [catalog.trim_indices(l, u) for l, u in zip(ll, ul)]
    freq_sim = np.concatenate([catalog.frequency[i:i2] for i, i2 in chunks])

    int_comps, tau_comps = [], []
    with np.errstate(under="ignore", over="ignore"):
        for ci in range(len(C)):
            Q = float(q_model.host_eval(T[ci]))
            tau_full = tau_sticks(
                np, catalog.frequency, catalog.elower, catalog.aij,
                catalog.gup, catalog.glow, Q, C[ci], T[ci], dV[ci],
            )
            tau = np.concatenate([tau_full[i:i2] for i, i2 in chunks])
            ints = stick_spectrum(np, freq_sim, tau, T[ci], Tbg, source_size, dish_size)
            int_comps.append(ints)
            tau_comps.append(tau)

    return freq_sim, np.sum(int_comps, axis=0), np.sum(tau_comps, axis=0)


def simulate_gauss_host(
    catalog: Catalog,
    C,
    dV,
    T,
    vlsr,
    ll,
    ul,
    res,
    source_size: float,
    dish_size: float,
    q_model: QModel | None = None,
):
    """Gaussian-rendered simulation, equivalent to MolSim(..., gauss=True)
    (reference classes.py:336-397 with functions.py:544-623), float64 host.

    Per component and per [ll, ul] chunk: render the trimmed opacity
    sticks onto the adaptive-then-uniform grid (render_gaussian_profile ==
    reference sim_gaussian), apply beam dilution, shift the simulated
    frame by the component's vlsr and re-interpolate back onto the
    unshifted uniform grid (reference classes.py:379-386), then sum the
    components.

    Reference quirk reproduced deliberately: in gauss mode the radiative
    transfer (J_T - J_Tbg)(1 - exp(-tau)) is commented out inside
    sim_gaussian (reference functions.py:613-617 sets
    ``int_gauss_tau = int_gauss``), so the returned "intensity" is the
    beam-diluted rendered *opacity*, not brightness temperature.

    C, dV, T, vlsr are per-component sequences; ll, ul, res per-chunk
    sequences. Returns (freq_sim, int_sim, tau_sim): freq_sim the
    concatenated uniform chunk grids, int_sim summed over components on
    that grid, tau_sim the per-line stick opacities summed over components
    (sticks stay per-line even in gauss mode, reference classes.py:361).
    """
    from cha1_mcmc_tpu.analysis.renderer import render_gaussian_profile
    from cha1_mcmc_tpu.ops.lte import apply_beam

    C = np.atleast_1d(np.asarray(C, dtype=np.float64))
    dV = np.atleast_1d(np.asarray(dV, dtype=np.float64))
    T = np.atleast_1d(np.asarray(T, dtype=np.float64))
    vlsr = np.atleast_1d(np.asarray(vlsr, dtype=np.float64))
    ll = np.atleast_1d(np.asarray(ll, dtype=np.float64))
    ul = np.atleast_1d(np.asarray(ul, dtype=np.float64))
    res = np.atleast_1d(np.asarray(res, dtype=np.float64))
    if res.size == 1 and ll.size > 1:
        res = np.full(ll.size, res[0])
    if q_model is None:
        q_model = q_model_for_catalog(catalog)

    chunks = [catalog.trim_indices(l, u) for l, u in zip(ll, ul)]
    freq_sim = None
    int_comps, tau_comps = [], []
    with np.errstate(under="ignore", over="ignore"):
        for ci in range(len(C)):
            Q = float(q_model.host_eval(T[ci]))
            tau_full = tau_sticks(
                np, catalog.frequency, catalog.elower, catalog.aij,
                catalog.gup, catalog.glow, Q, C[ci], T[ci], dV[ci],
            )
            int_chunks, freq_chunks = [], []
            for cj, (i, i2) in enumerate(chunks):
                fg, int_g = render_gaussian_profile(
                    catalog.frequency[i:i2], tau_full[i:i2], dV=dV[ci],
                    ll=ll[cj], ul=ul[cj], res=res[cj])
                int_g = apply_beam(np, fg, int_g, source_size, dish_size)
                # vlsr shift of the simulated frame, re-interpolated back
                # onto the unshifted grid (reference classes.py:379-386)
                freq_obs = fg + (-vlsr[ci]) * fg / CKM
                int_chunks.append(np.interp(fg, freq_obs, int_g))
                freq_chunks.append(fg)
            if freq_sim is None:  # reference extends freq_sim for i==0 only
                freq_sim = np.concatenate(freq_chunks)
            int_comps.append(np.concatenate(int_chunks))
            tau_comps.append(np.concatenate(
                [tau_full[i:i2] for i, i2 in chunks]))

    return freq_sim, np.sum(int_comps, axis=0), np.sum(tau_comps, axis=0)


def catalog_lines(catalog: Catalog, covered_idx, ll: float, ul: float):
    """(freq, elower, aij, gup, glow) float64 host arrays of the covered
    lines: `covered_idx` indexes the catalog trimmed to (ll, ul], as the
    reference's covered_trans does (reference inference.py:142-144)."""
    i, i2 = catalog.trim_indices(ll, ul)
    sel = np.arange(i, i2)[np.asarray(covered_idx, dtype=int)]
    return (catalog.frequency[sel], catalog.elower[sel], catalog.aij[sel],
            catalog.gup[sel], catalog.glow[sel])


def forward_host(lines, q_model: QModel, grid_freq, *, vel_offset: float,
                 mask_center: float, dish_size: float, Tbg: float,
                 source_size, Ncol, Tex: float, vlsr, dV: float,
                 chunk: int = 1024) -> np.ndarray:
    """Float64 NumPy oracle of :func:`forward_from_lines` for one theta.

    Same physics (reference inference.py:44-61,
    TMC1_four_component.py:148-181), written independently of the device
    code: the velocity grid is rebuilt from frequencies in float64, the
    line sum runs in chunks of `chunk` lines so a dense catalog's (L, C)
    grid never materializes, and Q is the exact host formula. `lines` is
    (freq, elower, aij, gup, glow); source_size, Ncol, vlsr are scalars
    or per-component sequences. Returns the (C,) model in K.
    """
    freq, elower, aij, gup, glow = (np.asarray(a, dtype=np.float64)
                                    for a in lines)
    grid = np.asarray(grid_freq, dtype=np.float64)
    Ncol = np.atleast_1d(np.asarray(Ncol, dtype=np.float64))
    vlsr = np.broadcast_to(np.asarray(vlsr, dtype=np.float64), Ncol.shape)
    ss = np.broadcast_to(np.asarray(source_size, dtype=np.float64), Ncol.shape)
    Q = float(q_model.host_eval(float(Tex)))
    sigma = dV / FWHM_TO_SIGMA_MODEL
    J = (planck_J(np, grid, Tex, guard=1e-10)
         - planck_J(np, grid, Tbg, guard=1e-10))
    out = np.zeros(grid.shape)
    with np.errstate(under="ignore", over="ignore"):
        for k in range(Ncol.size):
            taus = tau_sticks(np, freq, elower, aij, gup, glow, Q, Ncol[k],
                              Tex, dV)
            opac = np.zeros(grid.shape)
            for s in range(0, freq.size, chunk):
                lf = freq[s:s + chunk, None]
                vel = (lf - grid[None, :]) / lf * CKM + vel_offset
                window = np.abs(vel - mask_center) < VELOCITY_WINDOW_DV * dV
                z = (vel - vlsr[k]) / sigma
                opac += taus[s:s + chunk] @ np.where(window,
                                                     np.exp(-0.5 * z * z), 0.0)
            out += (beam_dilution(np, grid, ss[k], dish_size) * J
                    * (1.0 - np.exp(-opac)))
    return out


def forward_from_lines(
    line_freq, line_elower, line_aij, line_gup, line_glow, vel_grid,
    q_model: QModel, grid_freq, mask_center, dish_size, Tbg, dtype,
    source_size, Ncol, Tex, vlsr, dV, axis_name: str | None = None,
):
    """Composite emission model from explicit (possibly sharded) line arrays.

    This is the single implementation behind :meth:`SpectralModel.forward`;
    it exists as a free function so the line axis can be sharded across a
    device mesh: each device accumulates opacity over its local line shard
    and `axis_name` names the mesh axis to `psum` the partial accumulation
    over (see cha1_mcmc_tpu.parallel). The physics is identical to the
    reference hot loop (reference inference.py:44-61,
    TMC1_four_component.py:148-181).
    """
    source_size = jnp.atleast_1d(jnp.asarray(source_size, dtype=dtype))
    Ncol = jnp.atleast_1d(jnp.asarray(Ncol, dtype=dtype))
    vlsr = jnp.atleast_1d(jnp.asarray(vlsr, dtype=dtype))
    Tex = jnp.asarray(Tex, dtype=dtype)
    dV = jnp.asarray(dV, dtype=dtype)

    Q = q_model(Tex)
    taus = tau_sticks(jnp, line_freq, line_elower, line_aij, line_gup, line_glow,
                      Q, Ncol[..., None], Tex, dV)            # (ncomp, L)

    sigma = dV / FWHM_TO_SIGMA_MODEL
    window = jnp.abs(vel_grid - mask_center) < VELOCITY_WINDOW_DV * dV
    z = (vel_grid - vlsr[..., None, None]) / sigma
    gauss = jnp.where(window, jnp.exp(-0.5 * z * z), 0.0)      # (ncomp, L, C)
    # Contraction over lines (a batched mat-vec under walker batching).
    # HIGHEST keeps the f32 dot out of TF32 on tensor-core GPUs.
    opac = jnp.einsum("...l,...lc->...c", taus, gauss,
                      precision=jax.lax.Precision.HIGHEST)     # (ncomp, C)
    if axis_name is not None:
        opac = jax.lax.psum(opac, axis_name)

    # Hot-loop J uses the +1e-10 overflow guard (reference inference.py:56-57).
    J_T = planck_J(jnp, grid_freq, Tex, guard=1e-10)
    J_Tbg = planck_J(jnp, grid_freq, jnp.asarray(Tbg, dtype=dtype), guard=1e-10)
    dil = beam_dilution(jnp, grid_freq, source_size[:, None], dish_size)
    # -expm1(-tau) == 1 - exp(-tau) without the f32 cancellation at small
    # opacity (optically thin lines).
    comps = dil * (J_T - J_Tbg) * -jnp.expm1(-opac)            # (ncomp, C)
    return jnp.sum(comps, axis=0)


@dataclasses.dataclass(frozen=True)
class SpectralModel:
    """Jitted on-grid emission model over the covered lines.

    Static data (device constants under jit):
      line_*      — (L,) covered-line catalog arrays
      grid_freq   — (C,) observed channel frequencies, MHz
      vel_grid    — (L, C) velocity of each channel relative to each line,
                    including `vel_offset` (reference inference.py:51)
      q_model     — jittable partition function

    Geometry knobs reproduce both reference model variants:
      * single component (reference inference.py:44-61):
        vel_offset = aligned_velocity, mask_center = aligned_velocity
      * TMC-1 multi component (reference
        scripts/MCMC/TMC1_four_component.py:148-181):
        vel_offset = 0, mask_center = 5.8 (the source's aligned velocity)
    """

    line_freq: jnp.ndarray
    line_elower: jnp.ndarray
    line_aij: jnp.ndarray
    line_gup: jnp.ndarray
    line_glow: jnp.ndarray
    q_model: QModel
    grid_freq: jnp.ndarray
    vel_grid: jnp.ndarray
    mask_center: float
    dish_size: float
    Tbg: float = T_CMB
    dtype: jnp.dtype = jnp.float32
    vel_offset: float = 0.0

    @staticmethod
    def build(
        catalog: Catalog,
        covered_idx: np.ndarray,
        grid_freq: np.ndarray,
        *,
        ll: float,
        ul: float,
        dish_size: float,
        vel_offset: float,
        mask_center: float,
        Tbg: float = T_CMB,
        q_model: QModel | None = None,
        dtype=jnp.float32,
    ) -> "SpectralModel":
        """Assemble a model from a catalog and a reduced datagrid.

        `covered_idx` indexes into the catalog *trimmed* to (ll, ul], exactly
        as the reference's covered_trans indexes the trimmed simulation
        (reference inference.py:142-144 after classes.py:358-364).
        """
        if q_model is None:
            q_model = q_model_for_catalog(catalog)
        return SpectralModel.from_lines(
            catalog_lines(catalog, covered_idx, ll, ul), q_model, grid_freq,
            dish_size=dish_size, vel_offset=vel_offset,
            mask_center=mask_center, Tbg=Tbg, dtype=dtype)

    @staticmethod
    def from_lines(lines, q_model: QModel, grid_freq, *, dish_size: float,
                   vel_offset: float, mask_center: float, Tbg: float = T_CMB,
                   dtype=jnp.float32) -> "SpectralModel":
        """Assemble a model from host (freq, elower, aij, gup, glow) line
        arrays (catalog_lines, or a generated line list) and a channel
        grid."""
        line_freq, elower, aij, gup, glow = (np.asarray(a) for a in lines)
        grid_freq = np.asarray(grid_freq, dtype=np.float64)
        # Static (L, C) velocity grid (reference inference.py:51 computes this
        # per likelihood call; it depends only on static frequencies).
        vel_grid = (line_freq[:, None] - grid_freq[None, :]) / line_freq[:, None] * CKM + vel_offset
        return SpectralModel(
            line_freq=jnp.asarray(line_freq, dtype=dtype),
            line_elower=jnp.asarray(elower, dtype=dtype),
            line_aij=jnp.asarray(aij, dtype=dtype),
            line_gup=jnp.asarray(gup, dtype=dtype),
            line_glow=jnp.asarray(glow, dtype=dtype),
            q_model=q_model,
            grid_freq=jnp.asarray(grid_freq, dtype=dtype),
            vel_grid=jnp.asarray(vel_grid, dtype=dtype),
            mask_center=float(mask_center),
            dish_size=float(dish_size),
            Tbg=float(Tbg),
            dtype=dtype,
            vel_offset=float(vel_offset),
        )

    @property
    def n_lines(self) -> int:
        return int(self.line_freq.shape[0])

    @property
    def n_channels(self) -> int:
        return int(self.grid_freq.shape[0])

    def forward(self, source_size, Ncol, Tex, vlsr, dV, axis_name: str | None = None):
        """Composite emission model on the channel grid, in K.

        source_size, Ncol, vlsr: scalars or (ncomp,); Tex, dV: scalars.
        Each component is radiative-transferred and beam-diluted
        independently, then summed (reference TMC1_four_component.py:173-179;
        a single component reduces to reference inference.py:56-61).
        """
        return forward_from_lines(
            self.line_freq, self.line_elower, self.line_aij, self.line_gup,
            self.line_glow, self.vel_grid, self.q_model, self.grid_freq,
            self.mask_center, self.dish_size, self.Tbg, self.dtype,
            source_size, Ncol, Tex, vlsr, dV, axis_name=axis_name)

    def chi2_lnlike(self, model, grid_ints, inv_sigma2):
        """-0.5 * sum[(y - m)^2 / sigma^2 - ln(1/sigma^2)]
        (reference inference.py:157-166)."""
        resid = grid_ints - model
        return -0.5 * jnp.sum(resid * resid * inv_sigma2 - jnp.log(inv_sigma2))
