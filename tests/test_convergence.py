"""Convergence diagnostics, distributional parity with a NumPy
implementation of the emcee v3 stretch move, and chain resume."""

import contextlib
import io
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy import stats

from cha1_mcmc_tpu.sampler import (
    run_ensemble,
    autocorr_time,
    effective_sample_size,
    gelman_rubin,
    summarize_convergence,
)
from tests.conftest import requires_reference, CATALOG_DIR, HC5N_DATA


def _numpy_stretch_sampler(lnprob, pos0, nsteps, seed, a=2.0):
    """Plain-NumPy implementation of the emcee v3 stretch move (randomized
    split, sequential halves, z = ((a-1)u+1)^2/a, accept
    ln U < (d-1) ln z + dlnp) — an independent oracle for distributional
    comparison (emcee itself is not installed here)."""
    rng = np.random.default_rng(seed)
    coords = np.array(pos0, dtype=np.float64)
    W, D = coords.shape
    lnp = np.array([lnprob(c) for c in coords])
    chain = np.empty((nsteps, W, D))
    for step in range(nsteps):
        inds = rng.permutation(W) % 2
        for split in (0, 1):
            S = np.where(inds == split)[0]
            C = np.where(inds != split)[0]
            z = ((a - 1.0) * rng.random(len(S)) + 1.0) ** 2 / a
            partners = coords[rng.choice(C, size=len(S))]
            prop = partners + z[:, None] * (coords[S] - partners)
            lnp_new = np.array([lnprob(p) for p in prop])
            accept = np.log(rng.random(len(S))) < (D - 1) * np.log(z) + lnp_new - lnp[S]
            coords[S[accept]] = prop[accept]
            lnp[S[accept]] = lnp_new[accept]
        chain[step] = coords
    return chain


def test_distributional_parity_with_numpy_stretch():
    """Same skewed target, my JAX sampler vs the NumPy stretch oracle:
    matching moments and KS-compatible marginals."""
    mean = np.array([1.0, -0.5])
    cov = np.array([[1.0, 0.8], [0.8, 2.0]])
    icov = np.linalg.inv(cov)

    def lnprob_np(x):
        d = x - mean
        # skewed: Gaussian plus a soft positivity tilt in dim 0
        return -0.5 * d @ icov @ d - 0.1 * abs(x[0]) ** 3 / 10

    icov_j = jnp.asarray(icov, jnp.float32)
    mean_j = jnp.asarray(mean, jnp.float32)

    def lnprob_jax(x):
        d = x - mean_j
        return -0.5 * d @ icov_j @ d - 0.1 * jnp.abs(x[0]) ** 3 / 10

    W, steps, burn = 64, 3000, 600
    pos0 = np.random.default_rng(0).normal(size=(W, 2)) * 0.3 + mean
    ref_chain = _numpy_stretch_sampler(lnprob_np, pos0, steps, seed=1)
    lnp0 = jax.vmap(lnprob_jax)(jnp.asarray(pos0, jnp.float32))
    my_chain, *_ = run_ensemble(lnprob_jax, jnp.asarray(pos0, jnp.float32),
                                lnp0, jax.random.PRNGKey(2), nsteps=steps)
    a = ref_chain[burn:].reshape(-1, 2)
    b = np.asarray(my_chain[burn:]).reshape(-1, 2)
    np.testing.assert_allclose(a.mean(0), b.mean(0), atol=0.06)
    np.testing.assert_allclose(a.std(0), b.std(0), rtol=0.06)
    # thinned KS test per dimension (samples autocorrelated; thin by ~tau)
    for d in range(2):
        ks = stats.ks_2samp(a[::97, d], b[::97, d])
        assert ks.pvalue > 1e-4, (d, ks)


def test_distributional_parity_with_vendored_emcee():
    """JAX sampler vs the vendored emcee 3.1.6 reconstruction
    (tests/vendor_emcee.py — class-for-class the published
    emcee/moves/stretch.py + red_blue.py semantics the reference drives at
    reference inference.py:455-473). Independent of the hand-rolled oracle
    above: RandomState stream, emcee's own shuffle/randint call order, and
    the RedBlueMove update loop. Matching moments + KS-compatible
    marginals on the same skewed target."""
    from tests.vendor_emcee import EnsembleSampler

    mean = np.array([1.0, -0.5])
    cov = np.array([[1.0, 0.8], [0.8, 2.0]])
    icov = np.linalg.inv(cov)

    def lnprob_np(x):
        d = x - mean
        return -0.5 * d @ icov @ d - 0.1 * abs(x[0]) ** 3 / 10

    icov_j = jnp.asarray(icov, jnp.float32)
    mean_j = jnp.asarray(mean, jnp.float32)

    def lnprob_jax(x):
        d = x - mean_j
        return -0.5 * d @ icov_j @ d - 0.1 * jnp.abs(x[0]) ** 3 / 10

    W, steps, burn = 64, 3000, 600
    pos0 = np.random.default_rng(0).normal(size=(W, 2)) * 0.3 + mean
    sampler = EnsembleSampler(W, 2, lnprob_np, seed=42)
    ref_chain, _ = sampler.run_mcmc(pos0, steps)
    assert 0.3 < sampler.acceptance_fraction.mean() < 0.9

    lnp0 = jax.vmap(lnprob_jax)(jnp.asarray(pos0, jnp.float32))
    my_chain, *_ = run_ensemble(lnprob_jax, jnp.asarray(pos0, jnp.float32),
                                lnp0, jax.random.PRNGKey(7), nsteps=steps)
    a = ref_chain[burn:].reshape(-1, 2)
    b = np.asarray(my_chain[burn:]).reshape(-1, 2).astype(np.float64)
    np.testing.assert_allclose(a.mean(0), b.mean(0), atol=0.06)
    np.testing.assert_allclose(a.std(0), b.std(0), rtol=0.06)
    for d in range(2):
        ks = stats.ks_2samp(a[::97, d], b[::97, d])
        assert ks.pvalue > 1e-4, (d, ks)

    # the two independent oracles must themselves agree (guards against a
    # shared misreading between hand-rolled oracle and sampler)
    other = _numpy_stretch_sampler(lnprob_np, pos0, steps, seed=5)
    c = other[burn:].reshape(-1, 2)
    np.testing.assert_allclose(a.mean(0), c.mean(0), atol=0.06)
    np.testing.assert_allclose(a.std(0), c.std(0), rtol=0.06)


def test_diagnostics_on_gaussian_chain():
    def lnprob(x):
        return -0.5 * jnp.sum(x * x)

    W, steps = 32, 3000
    pos0 = jax.random.normal(jax.random.PRNGKey(0), (W, 3)) * 0.1
    lnp0 = jax.vmap(lnprob)(pos0)
    chain, *_ = run_ensemble(lnprob, pos0, lnp0, jax.random.PRNGKey(1), nsteps=steps)
    chain = np.asarray(chain).transpose(1, 0, 2)  # (W, S, D)
    tau = autocorr_time(chain[:, 500:, :])
    assert np.all(tau > 1) and np.all(tau < 200)
    ess = effective_sample_size(chain[:, 500:, :])
    assert np.all(ess > 500)
    r = gelman_rubin(chain[:, 500:, :])
    np.testing.assert_allclose(r, 1.0, atol=0.05)
    summary = summarize_convergence(chain)
    assert set(summary) == {"tau", "ess", "r_hat", "nsteps_post_burn"}


def test_diagnostics_flag_unconverged():
    """Walkers stuck in two separated modes must show R-hat >> 1."""
    rng = np.random.default_rng(0)
    half = rng.normal(size=(8, 200, 1)) * 0.1
    chain = np.concatenate([half - 5.0, half + 5.0], axis=0)
    assert gelman_rubin(chain).max() > 2.0


def test_fit_resume_appends(hc5n_inputs, tmp_path):
    from cha1_mcmc_tpu import FitConfig, SpectralFit

    base = dict(mol_name="hc5n_hfs", template_run=True, nwalkers=16,
                cat_folder=hc5n_inputs[0], data_path=hc5n_inputs[1],
                fit_folder=str(tmp_path / "results"), seed=0,
                checkpoint_every=20, MLE_for_Ncol=False)
    cfg = FitConfig(nruns=30, **base)
    with contextlib.redirect_stdout(io.StringIO()):
        chain1 = SpectralFit(cfg).run()
    cfg2 = FitConfig(nruns=20, resume=True, **base)
    with contextlib.redirect_stdout(io.StringIO()):
        chain2 = SpectralFit(cfg2).run()
    assert chain2.shape == (16, 50, 4)
    np.testing.assert_array_equal(chain2[:, :30, :], chain1)
    saved = np.load(cfg2.chain_path)
    assert saved.shape == (16, 50, 4)


@requires_reference
def test_dense_catalog_batched_fit(tmp_path):
    """End-to-end fit against a dense catalog (benzonitrile, 4400 lines)
    with a synthetic spectrum, through the batched likelihood path."""
    from cha1_mcmc_tpu.catalogs import load_catalog
    from cha1_mcmc_tpu.models.forward import SpectralModel, simulate_sticks_host
    from cha1_mcmc_tpu.inference import (ParamSpec, single_component_lnprior)
    from cha1_mcmc_tpu.inference.likelihood import build_lnprob_batched
    from cha1_mcmc_tpu.sampler import EnsembleSampler

    cat = load_catalog(os.path.join(CATALOG_DIR, "benzonitrile.cat"))
    ll, ul = 18000.0, 25000.0
    i, i2 = cat.trim_indices(ll, ul)
    truth = dict(Ncol=5e11, Tex=8.0, vlsr=4.1, dV=0.7)

    # Synthetic observation: channels around the 40 brightest lines
    freq, ints, taus = simulate_sticks_host(
        cat, C=[truth["Ncol"]], dV=[truth["dV"]], T=[truth["Tex"]],
        ll=[ll], ul=[ul], source_size=52.0, dish_size=70)
    top = np.argsort(ints)[-40:]
    rng = np.random.default_rng(0)
    grid_freq = np.sort(np.concatenate(
        [freq[t] + np.linspace(-0.3, 0.3, 41) for t in top]))
    covered = np.arange(i2 - i)  # all trimmed lines participate

    spec = ParamSpec(ncomp=1, fixed_source_size=52.0)
    model = SpectralModel.build(cat, covered, grid_freq, ll=ll, ul=ul,
                                dish_size=70, vel_offset=4.1, mask_center=4.1)
    assert model.n_lines > 1000  # dense: benzonitrile has 1240 lines in-window
    theta_true = np.array([truth["Ncol"], truth["Tex"], truth["vlsr"], truth["dV"]])
    clean = np.asarray(model.forward(52.0, *theta_true))
    noise = 0.1 * np.abs(clean).max()
    y = clean + rng.normal(0, noise, clean.shape)
    yerr = np.full_like(y, noise)

    bounds = {"source_size": (30.0, 90.0), "Ncol": (1e8, 1e14),
              "Tex": (3.5, 12.0), "vlsr": (3.0, 5.5), "dV": (0.4, 1.5)}
    lnprior = single_component_lnprior(
        spec, bounds, np.array([5e11, 8.0, 4.1, 0.7]),
        np.array([1e11, 1.0, 0.06, 0.2]))
    lnprob = build_lnprob_batched(model, spec, y, yerr, lnprior)

    s = EnsembleSampler(lnprob_fn=lnprob, nwalkers=16, ndim=4, batched=True)
    pos0 = theta_true * (1 + 0.05 * rng.standard_normal((16, 4)))
    s.run_mcmc(pos0, 40, jax.random.PRNGKey(0), checkpoint_every=40)
    med = np.median(s.chain[:, 20:, :].reshape(-1, 4), axis=0)
    assert np.isclose(med[0], truth["Ncol"], rtol=0.3)
    assert np.isclose(med[2], truth["vlsr"], atol=0.05)


def test_exact_resume_equals_uninterrupted(hc5n_inputs, tmp_path):
    """A run interrupted at a checkpoint and resumed via the state sidecar
    reproduces the uninterrupted chain bit for bit."""
    from cha1_mcmc_tpu import FitConfig, SpectralFit

    base = dict(mol_name="hc5n_hfs", template_run=True, nwalkers=16,
                cat_folder=hc5n_inputs[0], data_path=hc5n_inputs[1], seed=4,
                checkpoint_every=10, MLE_for_Ncol=False)
    cfg_full = FitConfig(nruns=40, fit_folder=str(tmp_path / "full"), **base)
    with contextlib.redirect_stdout(io.StringIO()):
        chain_full = SpectralFit(cfg_full).run()

    cfg_a = FitConfig(nruns=20, fit_folder=str(tmp_path / "split"), **base)
    with contextlib.redirect_stdout(io.StringIO()):
        SpectralFit(cfg_a).run()
    cfg_b = FitConfig(nruns=20, resume=True, fit_folder=str(tmp_path / "split"), **base)
    with contextlib.redirect_stdout(io.StringIO()):
        chain_split = SpectralFit(cfg_b).run()
    np.testing.assert_array_equal(chain_full, chain_split)


def test_distributional_parity_with_real_emcee():
    """Close the loop against the GENUINE emcee package (the reference pins
    emcee==3.1.6, reference requirements.txt:8, driven at
    inference.py:455-473) whenever it is importable.

    Environment probe (2026-08-17, re-run 2026-08-19, this machine):
    `import emcee` fails, `pip install`/`pip download emcee` both return
    "No matching distribution found" (pypi.org does not resolve — zero
    network egress), and a full filesystem scan finds no emcee wheel
    or source tree anywhere on disk — the real package CANNOT be obtained
    here, so this test self-skips and the two independent oracles above
    (hand-rolled NumPy stretch + the class-for-class vendor_emcee
    reconstruction) carry the parity gate. If emcee ever appears in the
    image, this test runs the same distributional gate against it with no
    further changes."""
    emcee = pytest.importorskip("emcee")
    if emcee.EnsembleSampler is object:
        # tests/reference_oracle.py registers a stub "emcee" module so the
        # reference's inference.py imports — that is not the real package
        pytest.skip("only the reference-oracle emcee stub is present")

    mean = np.array([1.0, -0.5])
    cov = np.array([[1.0, 0.8], [0.8, 2.0]])
    icov = np.linalg.inv(cov)

    def lnprob_np(x):
        d = x - mean
        return -0.5 * d @ icov @ d - 0.1 * abs(x[0]) ** 3 / 10

    icov_j = jnp.asarray(icov, jnp.float32)
    mean_j = jnp.asarray(mean, jnp.float32)

    def lnprob_jax(x):
        d = x - mean_j
        return -0.5 * d @ icov_j @ d - 0.1 * jnp.abs(x[0]) ** 3 / 10

    W, steps, burn = 64, 3000, 600
    pos0 = np.random.default_rng(0).normal(size=(W, 2)) * 0.3 + mean
    sampler = emcee.EnsembleSampler(W, 2, lnprob_np)
    sampler.random_state = np.random.RandomState(42).get_state()
    sampler.run_mcmc(pos0, steps)
    ref_chain = sampler.get_chain()

    lnp0 = jax.vmap(lnprob_jax)(jnp.asarray(pos0, jnp.float32))
    my_chain, *_ = run_ensemble(lnprob_jax, jnp.asarray(pos0, jnp.float32),
                                lnp0, jax.random.PRNGKey(7), nsteps=steps)
    a = ref_chain[burn:].reshape(-1, 2)
    b = np.asarray(my_chain[burn:]).reshape(-1, 2).astype(np.float64)
    np.testing.assert_allclose(a.mean(0), b.mean(0), atol=0.06)
    np.testing.assert_allclose(a.std(0), b.std(0), rtol=0.06)
    for d in range(2):
        ks = stats.ks_2samp(a[::97, d], b[::97, d])
        assert ks.pvalue > 1e-4, (d, ks)


def test_adaptive_metropolis_on_gaussian():
    """The independent engine itself: adaptive RWM must recover a known
    correlated 2-D Gaussian (mean, marginal stds, correlation)."""
    from cha1_mcmc_tpu.analysis import run_adaptive_metropolis

    mean = jnp.asarray([1.5, -2.0], jnp.float32)
    cov = np.array([[1.0, 0.8], [0.8, 1.0]])
    icov = jnp.asarray(np.linalg.inv(cov), jnp.float32)

    def lnprob(x):
        d = x - mean
        return -0.5 * d @ icov @ d

    W = 64
    pos0 = jax.random.normal(jax.random.PRNGKey(0), (W, 2)) * 0.3
    chain, lnps, acc = run_adaptive_metropolis(
        lnprob, pos0, jax.random.PRNGKey(3), nsteps=3000,
        init_sigma=np.array([0.1, 0.1]))
    assert 0.1 < acc < 0.6
    s = np.asarray(chain)[600:].reshape(-1, 2).astype(np.float64)
    np.testing.assert_allclose(s.mean(0), np.asarray(mean), atol=0.05)
    np.testing.assert_allclose(s.std(0), 1.0, rtol=0.06)
    np.testing.assert_allclose(np.corrcoef(s.T)[0, 1], 0.8, atol=0.05)


def test_independent_engine_cross_validation_hc5n(hc5n_problem):
    """Engine-independent posterior cross-check on the HC5N fit —
    the native stand-in for the reference's CASSIS validation
    (scripts/CASSIS/Cha1_HC5N_CASSIS.py:133 computeChi2MinUsingMCMC):
    a fixed-kernel adaptive-Metropolis engine that shares no move
    machinery with the stretch sampler must reproduce the stretch
    sampler's posterior."""
    from cha1_mcmc_tpu.analysis import run_adaptive_metropolis

    lnprob = hc5n_problem["lnprob"]
    means, stds = hc5n_problem["means"], hc5n_problem["stds"]
    W = 128
    rng = np.random.default_rng(11)
    pos0 = jnp.asarray(means + (stds / 10) * rng.standard_normal((W, 4)),
                       jnp.float32)

    lnp0 = jax.vmap(lnprob)(pos0)
    schain, *_ = run_ensemble(lnprob, pos0, lnp0, jax.random.PRNGKey(5),
                              nsteps=1200)
    mchain, _, acc = run_adaptive_metropolis(
        lnprob, pos0, jax.random.PRNGKey(6), nsteps=2400,
        init_sigma=stds / 10)
    assert 0.1 < acc < 0.6

    s = np.asarray(schain)[300:].reshape(-1, 4).astype(np.float64)
    m = np.asarray(mchain)[600:].reshape(-1, 4).astype(np.float64)
    pooled = s.std(0)
    # means agree to a small fraction of the posterior scale; spreads
    # agree relatively (MC error at these ESS is ~2% of std per engine)
    assert np.all(np.abs(s.mean(0) - m.mean(0)) < 0.15 * pooled)
    np.testing.assert_allclose(s.std(0), m.std(0), rtol=0.25)
