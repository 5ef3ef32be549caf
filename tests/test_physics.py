"""Physics primitives vs the reference formulas and stick-sim oracle."""

import numpy as np
import pytest
import jax.numpy as jnp

from cha1_mcmc_tpu.ops import planck_J, beam_dilution, tau_sticks, stick_spectrum
from cha1_mcmc_tpu.models.forward import simulate_sticks_host
from cha1_mcmc_tpu.catalogs import q_model_for_catalog
from tests.conftest import requires_reference, HC5N_CAT
from tests import reference_oracle


def test_planck_J_guarded_vs_reference_formula():
    h, k = 6.626e-34, 1.381e-23
    f = np.array([18e3, 20e3, 25e3])
    for T in (2.7, 7.0, 12.0):
        expected = (h * f * 1e6 / k) / (np.exp((h * f * 1e6) / (k * T)) - 1 + 1e-10)
        np.testing.assert_allclose(planck_J(np, f, T, guard=1e-10), expected, rtol=1e-12)


def test_beam_dilution_vs_reference_formula():
    cm = 2.998e8
    f = np.array([18e3, 25e3])
    wavelength = cm / (f * 1e6)
    beam = wavelength * 206265 * 1.22 / 70.0
    expected = 52.0 ** 2 / (beam ** 2 + 52.0 ** 2)
    np.testing.assert_allclose(beam_dilution(np, f, 52.0, 70.0), expected, rtol=1e-12)


@requires_reference
def test_stick_sim_matches_reference_molsim(hc5n_catalog):
    classes, _, _ = reference_oracle.load_reference()
    ref_cat = classes.MolCat("hc5n_hfs", HC5N_CAT)
    obs = classes.ObsParams("t", dish_size=70, source_size=52.0)
    for C, dV, T in [(3.4e12, 0.89, 7.0), (1e10, 0.5, 4.0), (5e13, 1.4, 11.5)]:
        sim = classes.MolSim("s", ref_cat, obs, vlsr=[4.1], C=[C], dV=[dV], T=[T],
                             ll=[18000], ul=[25000], gauss=False)
        f2, i2, t2 = simulate_sticks_host(
            hc5n_catalog, C=[C], dV=[dV], T=[T], ll=[18000], ul=[25000],
            source_size=52.0, dish_size=70)
        np.testing.assert_allclose(np.array(sim.freq_sim), f2)
        np.testing.assert_allclose(np.array(sim.int_sim), i2, rtol=1e-12)
        np.testing.assert_allclose(np.array(sim.tau_sim), t2, rtol=1e-12)


def test_multicomponent_stick_sum(hc5n_catalog):
    """Components sum after radiative transfer (reference classes.py:394-395)."""
    f, i_two, t_two = simulate_sticks_host(
        hc5n_catalog, C=[1e12, 2e12], dV=[0.8, 0.6], T=[7.0, 9.0],
        ll=[18000], ul=[25000], source_size=52.0, dish_size=70)
    _, i_a, t_a = simulate_sticks_host(
        hc5n_catalog, C=[1e12], dV=[0.8], T=[7.0], ll=[18000], ul=[25000],
        source_size=52.0, dish_size=70)
    _, i_b, t_b = simulate_sticks_host(
        hc5n_catalog, C=[2e12], dV=[0.6], T=[9.0], ll=[18000], ul=[25000],
        source_size=52.0, dish_size=70)
    np.testing.assert_allclose(i_two, i_a + i_b, rtol=1e-12)
    np.testing.assert_allclose(t_two, t_a + t_b, rtol=1e-12)


@requires_reference
def test_gauss_sim_matches_reference_molsim(hc5n_catalog):
    """Full gauss=True MolSim path — adaptive-grid Gaussian rendering,
    beam dilution, per-component vlsr shift with re-interpolation onto the
    unshifted grid, component summing (reference classes.py:336-397 +
    functions.py:544-623) — against simulate_gauss_host, multi-component
    and multi-chunk."""
    from cha1_mcmc_tpu.models.forward import simulate_gauss_host

    classes, _, _ = reference_oracle.load_reference()
    ref_cat = classes.MolCat("hc5n_hfs", HC5N_CAT)
    obs = classes.ObsParams("t", dish_size=70, source_size=52.0)
    cases = [
        dict(vlsr=[4.1], C=[3.4e12], dV=[0.89], T=[7.0],
             ll=[18630], ul=[18650], res=[0.01]),
        dict(vlsr=[4.1, 5.3], C=[3.4e12, 8e11], dV=[0.89, 0.55],
             T=[7.0, 9.5], ll=[18630], ul=[18650], res=[0.01]),
        dict(vlsr=[4.1, 5.3, 3.2], C=[3.4e12, 8e11, 2e12],
             dV=[0.89, 0.55, 1.2], T=[7.0, 9.5, 5.0],
             ll=[18630, 21290], ul=[18650, 21310], res=[0.01, 0.02]),
    ]
    for kw in cases:
        sim = classes.MolSim("s", ref_cat, obs, gauss=True, **kw)
        f2, i2, t2 = simulate_gauss_host(
            hc5n_catalog, C=kw["C"], dV=kw["dV"], T=kw["T"], vlsr=kw["vlsr"],
            ll=kw["ll"], ul=kw["ul"], res=kw["res"],
            source_size=52.0, dish_size=70)
        np.testing.assert_allclose(np.array(sim.freq_sim), f2)
        np.testing.assert_allclose(np.array(sim.int_sim), i2, rtol=1e-10)
        np.testing.assert_allclose(np.array(sim.tau_sim), t2, rtol=1e-12)


def test_device_tau_matches_host_f64(hc5n_catalog):
    """jnp float32 opacities agree with the float64 host oracle."""
    qm = q_model_for_catalog(hc5n_catalog)
    Q = qm.host_eval(7.0)
    host = tau_sticks(np, hc5n_catalog.frequency, hc5n_catalog.elower,
                      hc5n_catalog.aij, hc5n_catalog.gup, hc5n_catalog.glow,
                      Q, 3.4e12, 7.0, 0.89)
    dev = tau_sticks(jnp,
                     jnp.asarray(hc5n_catalog.frequency, jnp.float32),
                     jnp.asarray(hc5n_catalog.elower, jnp.float32),
                     jnp.asarray(hc5n_catalog.aij, jnp.float32),
                     jnp.asarray(hc5n_catalog.gup, jnp.float32),
                     jnp.asarray(hc5n_catalog.glow, jnp.float32),
                     jnp.float32(Q), jnp.float32(3.4e12), jnp.float32(7.0),
                     jnp.float32(0.89))
    np.testing.assert_allclose(np.asarray(dev), host, rtol=5e-5)


@requires_reference
def test_multichunk_stick_sim(hc5n_catalog):
    """Multiple [ll, ul] windows concatenate exactly as MolSim's per-chunk
    trim does (reference classes.py:356-364)."""
    classes, _, _ = reference_oracle.load_reference()
    ref_cat = classes.MolCat("hc5n_hfs", HC5N_CAT)
    obs = classes.ObsParams("t", dish_size=70, source_size=52.0)
    lls, uls = [18000, 23000], [19000, 25000]
    sim = classes.MolSim("s", ref_cat, obs, vlsr=[4.1], C=[3.4e12], dV=[0.89],
                         T=[7.0], ll=lls, ul=uls, gauss=False)
    f2, i2, t2 = simulate_sticks_host(
        hc5n_catalog, C=[3.4e12], dV=[0.89], T=[7.0], ll=lls, ul=uls,
        source_size=52.0, dish_size=70)
    np.testing.assert_allclose(np.array(sim.freq_sim), f2)
    np.testing.assert_allclose(np.array(sim.int_sim), i2, rtol=1e-12)
    np.testing.assert_allclose(np.array(sim.tau_sim), t2, rtol=1e-12)
