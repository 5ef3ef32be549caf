"""Differential tests of lnlike / lnprior / lnprob against the reference,
covering the 4-dim, 5-dim and 14-dim (TMC-1 4-component) parameterizations."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cha1_mcmc_tpu.catalogs import load_catalog
from cha1_mcmc_tpu.models.forward import SpectralModel
from cha1_mcmc_tpu.inference import (
    ParamSpec,
    single_component_lnprior,
    ordered_velocity_lnprior,
    build_lnprob,
    build_lnlike,
    estimate_ncol_mle,
)
from tests.conftest import requires_reference, CATALOG_DIR, HC9N_GOTHAM, HC5N_DATA
from tests import reference_oracle


@requires_reference
def test_lnprob_parity_4dim(hc5n_problem, hc5n_datagrid):
    _, _, inference = reference_oracle.load_reference()
    classes = reference_oracle.load_reference()[0]
    fitter = reference_oracle.make_reference_fitter(inference)
    ref_grid = hc5n_datagrid.as_object_array()
    mol_cat = classes.MolCat("mol", f"{CATALOG_DIR}/hc5n_hfs.cat")
    means, stds = hc5n_problem["means"], hc5n_problem["stds"]
    lnprob = hc5n_problem["lnprob"]

    rng = np.random.default_rng(42)
    for _ in range(25):
        theta = np.array([
            rng.uniform(1e9, 9e13), rng.uniform(3.6, 11.9),
            rng.uniform(3.1, 5.4), rng.uniform(0.41, 1.49)])
        ref_val = fitter.lnprob(theta, ref_grid, mol_cat, stds, means)
        my_val = float(lnprob(theta))
        assert np.isclose(my_val, ref_val, rtol=1e-4, atol=0.02), (theta, my_val, ref_val)


def test_lnprob_out_of_bounds_4dim(hc5n_problem):
    lnprob = hc5n_problem["lnprob"]
    for theta in [
        [1e15, 8.0, 4.3, 0.7],    # Ncol above
        [1e12, 2.0, 4.3, 0.7],    # Tex below
        [1e12, 8.0, 6.0, 0.7],    # vlsr above
        [1e12, 8.0, 4.3, 0.2],    # dV below
        [1e8, 8.0, 4.3, 0.7],     # exactly on (open) boundary
    ]:
        assert float(lnprob(np.array(theta))) == -np.inf


@requires_reference
def test_lnprob_parity_5dim(hc5n_catalog, hc5n_datagrid):
    classes, _, inference = reference_oracle.load_reference()
    fitter = reference_oracle.make_reference_fitter(
        inference, fixed_source_size=None,
        template_means=np.array([46.91, 3.4e10, 8.0, 4.3, 0.7575]),
        template_stds=np.array([6.5, 0.34e10, 3.0, 0.06, 0.22]))
    assert fitter.ndim == 5
    ref_grid = hc5n_datagrid.as_object_array()
    mol_cat = classes.MolCat("mol", f"{CATALOG_DIR}/hc5n_hfs.cat")

    spec = ParamSpec(ncomp=1, fixed_source_size=None)
    model = SpectralModel.build(
        hc5n_catalog, hc5n_datagrid.covered_trans, hc5n_datagrid.freqs,
        ll=18000, ul=25000, dish_size=70, vel_offset=4.10, mask_center=4.10)
    bounds = {"source_size": (30.0, 90.0), "Ncol": (1e8, 1e14),
              "Tex": (3.5, 12.0), "vlsr": (3.0, 5.5), "dV": (0.4, 1.5)}
    means = np.array([46.91, 3.4e10, 8.0, 4.3, 0.7575])
    stds = np.array([6.5, 0.34e10, 3.0, 0.06, 0.22])
    lnprior = single_component_lnprior(spec, bounds, means, stds)
    lnprob = jax.jit(build_lnprob(
        model, spec, hc5n_datagrid.ints, hc5n_datagrid.yerrs, lnprior))

    rng = np.random.default_rng(1)
    for _ in range(15):
        theta = np.array([
            rng.uniform(31, 89), rng.uniform(1e9, 9e13), rng.uniform(3.6, 11.9),
            rng.uniform(3.1, 5.4), rng.uniform(0.41, 1.49)])
        ref_val = fitter.lnprob(theta, ref_grid, mol_cat, stds, means)
        my_val = float(lnprob(theta))
        assert np.isclose(my_val, ref_val, rtol=1e-4, atol=0.02), (theta, my_val, ref_val)


def _gotham_datagrid(tmc1, classes, catfile):
    """Re-reduce the shipped pre-reduced GOTHAM spectrum through the
    reference's own GOTHAM read_file so covered_trans indices are consistent
    with the ll=7000 trim the TMC-1 lnlike uses (the shipped
    hc9n_hfs_chunks.npy carries full-catalog indices from an older
    reduction, which the shipped script itself cannot consume)."""
    import contextlib
    import io

    mol_cat = classes.MolCat("hc9n_hfs", catfile)
    obs = classes.ObsParams("init", source_size=40)
    sim = classes.MolSim("sim", mol_cat, obs, [0.0], [7.0e11], [0.37], [8.0],
                         ll=[7000], ul=[30000], gauss=False)
    with contextlib.redirect_stdout(io.StringIO()):
        out = tmc1.read_file(HC9N_GOTHAM, np.array(sim.freq_sim),
                             np.array(sim.int_sim), block_interlopers=True)
    freqs, ints, yerrs, covered = out
    return (np.array([freqs, ints, yerrs, np.array(covered, dtype=int)],
                     dtype=object),
            np.array(sim.freq_sim), np.array(sim.int_sim))


@requires_reference
def test_gotham_reduction_parity():
    """My GOTHAM-variant reduction matches the reference TMC-1 read_file."""
    import contextlib
    import io

    from cha1_mcmc_tpu.reduce.datagrid import read_spectrum_gotham

    tmc1 = reference_oracle.load_reference_tmc1()
    classes = reference_oracle.load_reference()[0]
    catfile = f"{CATALOG_DIR}/hc9n_hfs.cat"
    ref_grid, freq_sim, int_sim = _gotham_datagrid(tmc1, classes, catfile)
    data = np.load(HC9N_GOTHAM, allow_pickle=True)
    mine = read_spectrum_gotham(data, freq_sim, int_sim, verbose=False)
    np.testing.assert_array_equal(ref_grid[0], mine.freqs)
    np.testing.assert_array_equal(ref_grid[1], mine.ints)
    np.testing.assert_array_equal(ref_grid[2], mine.yerrs)
    np.testing.assert_array_equal(ref_grid[3], mine.covered_trans)


@requires_reference
def test_lnprob_parity_tmc1_14dim():
    """4-component GOTHAM model vs the reference TMC-1 script oracle."""
    tmc1 = reference_oracle.load_reference_tmc1()
    classes = reference_oracle.load_reference()[0]
    catfile = f"{CATALOG_DIR}/hc9n_hfs.cat"
    datagrid, _, _ = _gotham_datagrid(tmc1, classes, catfile)
    mol_cat = classes.MolCat("hc9n_hfs", catfile)

    catalog = load_catalog(catfile)
    spec = ParamSpec(ncomp=4)
    # TMC-1 geometry (reference TMC1_four_component.py:122,160,169-176):
    # ll=7000, ul=30000, dish=100, no vel offset, mask centered at 5.8 km/s.
    model = SpectralModel.build(
        catalog, np.asarray(datagrid[3], dtype=int), np.asarray(datagrid[0]),
        ll=7000, ul=30000, dish_size=100, vel_offset=0.0, mask_center=5.8)
    means = np.array([37, 25, 56, 22, 2.47e12, 11.19e12, 2.20e12, 5.64e12,
                      6.7, 5.624, 5.790, 5.910, 6.033, 0.117])
    stds = np.array([2.5, 2.0, 6.5, 2.0, 0.30e12, 1.75e12, 0.265e12, 1.185e12,
                     0.1, 0.0015, 0.001, 0.0035, 0.002, 0.002])
    lnprior = ordered_velocity_lnprior(spec, means, stds)
    lnprob = jax.jit(build_lnprob(
        model, spec, np.asarray(datagrid[1]), np.asarray(datagrid[2]), lnprior))

    rng = np.random.default_rng(3)
    n_checked = 0
    for _ in range(20):
        theta = means * (1 + 0.02 * rng.standard_normal(14))
        theta[9:13] = np.sort(theta[9:13])
        ref_val = tmc1.lnprob(theta, datagrid, mol_cat, stds, means)
        my_val = float(lnprob(theta))
        if np.isfinite(ref_val):
            assert np.isclose(my_val, ref_val, rtol=1e-4, atol=0.05), (my_val, ref_val)
            n_checked += 1
        else:
            assert my_val == -np.inf
    assert n_checked >= 5

    # velocity-ordering constraint violations reject
    bad = means.copy()
    bad[9], bad[10] = bad[10], bad[9]
    assert tmc1.lnprob(bad, datagrid, mol_cat, stds, means) == -np.inf
    assert float(lnprob(bad)) == -np.inf


def test_nan_rejection(hc5n_problem):
    """Non-finite parameters must reject, not poison the chain
    (reference inference.py:145-155 exception->-inf semantics)."""
    lnprob = hc5n_problem["lnprob"]
    assert float(lnprob(np.array([np.nan, 8.0, 4.3, 0.7]))) == -np.inf
    assert float(lnprob(np.array([1e12, np.inf, 4.3, 0.7]))) == -np.inf


@requires_reference
def test_mle_ncol_matches_reference(hc5n_problem, hc5n_datagrid):
    classes, _, inference = reference_oracle.load_reference()
    fitter = reference_oracle.make_reference_fitter(inference)
    ref_grid = hc5n_datagrid.as_object_array()
    mol_cat = classes.MolCat("mol", f"{CATALOG_DIR}/hc5n_hfs.cat")
    ref_est = fitter.estimate_Ncol_via_MLE(ref_grid, mol_cat, (8.0, 4.3, 0.7575))

    model, spec = hc5n_problem["model"], hc5n_problem["spec"]
    grid = hc5n_datagrid
    lnlike = build_lnlike(model, spec, grid.ints, grid.yerrs)
    my_est = estimate_ncol_mle(lnlike, spec, np.array([3.4e10, 8.0, 4.3, 0.7575]),
                               (1e8, 1e14))
    # f32 likelihood surface: agree within 0.5% on a ~1e12 scale
    assert np.isclose(my_est, ref_est, rtol=5e-3), (my_est, ref_est)
    # the on-device bracketing search and the reference-shaped scipy host
    # loop must find the same optimum
    scipy_est = estimate_ncol_mle(
        lnlike, spec, np.array([3.4e10, 8.0, 4.3, 0.7575]), (1e8, 1e14),
        method="scipy")
    assert np.isclose(my_est, scipy_est, rtol=5e-3), (my_est, scipy_est)


@requires_reference
def test_lnprob_float64_mode_matches_oracle_tightly(tmp_path):
    """With x64 enabled (float64 verification mode), lnprob matches the
    reference at near machine precision. Runs in a subprocess because
    jax_enable_x64 is process-global."""
    import os
    import subprocess
    import sys
    import textwrap

    script = textwrap.dedent("""
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import numpy as np
        import sys
        sys.path.insert(0, %r)
        from tests import reference_oracle
        from tests.conftest import CATALOG_DIR
        from cha1_mcmc_tpu.catalogs import load_catalog
        from cha1_mcmc_tpu.reduce.datagrid import reduce_spectrum
        from cha1_mcmc_tpu.models.forward import SpectralModel
        from cha1_mcmc_tpu.inference import (ParamSpec,
                                             single_component_lnprior,
                                             build_lnprob)
        import jax.numpy as jnp

        classes, _, inference = reference_oracle.load_reference()
        fitter = reference_oracle.make_reference_fitter(inference)
        cat = load_catalog(CATALOG_DIR + "/hc5n_hfs.cat")
        grid = reduce_spectrum(cat, %r, ll=18000, ul=25000,
                               aligned_velocity=4.10, dish_size=70,
                               source_size=52.0, verbose=False)
        mol_cat = classes.MolCat("mol", CATALOG_DIR + "/hc5n_hfs.cat")
        spec = ParamSpec(ncomp=1, fixed_source_size=52.0)
        model = SpectralModel.build(cat, grid.covered_trans, grid.freqs,
                                    ll=18000, ul=25000, dish_size=70,
                                    vel_offset=4.10, mask_center=4.10,
                                    dtype=jnp.float64)
        means = np.array([3.4e10, 8.0, 4.3, 0.7575])
        stds = np.array([0.34e10, 3.0, 0.06, 0.22])
        bounds = {"source_size": (30.0, 90.0), "Ncol": (1e8, 1e14),
                  "Tex": (3.5, 12.0), "vlsr": (3.0, 5.5), "dV": (0.4, 1.5)}
        lnprob = build_lnprob(model, spec, grid.ints, grid.yerrs,
                              single_component_lnprior(spec, bounds, means, stds))
        rng = np.random.default_rng(9)
        worst = 0.0
        for _ in range(10):
            theta = np.array([rng.uniform(1e10, 9e12), rng.uniform(4, 11),
                              rng.uniform(3.5, 5.0), rng.uniform(0.45, 1.4)])
            ref = fitter.lnprob(theta, grid.as_object_array(), mol_cat, stds, means)
            mine = float(lnprob(theta))
            worst = max(worst, abs(mine - ref))
        assert worst < 1e-8, worst
        print("WORST_ABS_DIFF", worst)
    """) % (os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            HC5N_DATA)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "WORST_ABS_DIFF" in out.stdout


@requires_reference
def test_batched_gather_matches_scalar_14dim():
    """The multi-component fit's default sparse path
    (build_lnprob_batched(use_pallas=True), ncomp=4, the
    MultiFitConfig.use_sparse_opacity default) == the vmapped scalar
    lnprob on the GOTHAM problem — same finiteness pattern, values to f32
    round-off — at the prior's dv_max=0.3 static-table bound."""
    tmc1 = reference_oracle.load_reference_tmc1()
    classes = reference_oracle.load_reference()[0]
    catfile = f"{CATALOG_DIR}/hc9n_hfs.cat"
    datagrid, _, _ = _gotham_datagrid(tmc1, classes, catfile)

    from cha1_mcmc_tpu.inference import build_lnprob_batched

    catalog = load_catalog(catfile)
    spec = ParamSpec(ncomp=4)
    model = SpectralModel.build(
        catalog, np.asarray(datagrid[3], dtype=int), np.asarray(datagrid[0]),
        ll=7000, ul=30000, dish_size=100, vel_offset=0.0, mask_center=5.8)
    means = np.array([37, 25, 56, 22, 2.47e12, 11.19e12, 2.20e12, 5.64e12,
                      6.7, 5.624, 5.790, 5.910, 6.033, 0.117])
    stds = np.array([2.5, 2.0, 6.5, 2.0, 0.30e12, 1.75e12, 0.265e12, 1.185e12,
                     0.1, 0.0015, 0.001, 0.0035, 0.002, 0.002])
    lnprior = ordered_velocity_lnprior(spec, means, stds)
    ints, yerrs = np.asarray(datagrid[1]), np.asarray(datagrid[2])
    scalar = jax.vmap(build_lnprob(model, spec, ints, yerrs, lnprior))
    batched = build_lnprob_batched(model, spec, ints, yerrs, lnprior,
                                   use_pallas=True, dv_max=0.3)
    rng = np.random.default_rng(5)
    thetas = means * (1 + 0.02 * rng.standard_normal((24, 14)))
    thetas[:, 9:13] = np.sort(thetas[:, 9:13], axis=1)
    a = np.asarray(scalar(jnp.asarray(thetas, jnp.float32)))
    b = np.asarray(batched(thetas))
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    keep = np.isfinite(a)
    assert keep.sum() >= 5
    np.testing.assert_allclose(a[keep], b[keep], rtol=2e-4, atol=0.05)


def test_mle_batched_gather_matches_scalar(hc5n_problem, hc5n_datagrid):
    """The batched-lnlike MLE (the path dense fits take: the scalar
    lnlike's (L, C) closure constant cannot compile there) finds the same
    optimum as the scalar-lnlike search on the flagship problem."""
    from cha1_mcmc_tpu.inference.likelihood import build_lnlike_batched

    model, spec = hc5n_problem["model"], hc5n_problem["spec"]
    grid = hc5n_datagrid
    lnlike = build_lnlike(model, spec, grid.ints, grid.yerrs)
    lnlike_b = build_lnlike_batched(model, spec, grid.ints, grid.yerrs,
                                    use_pallas=True, dv_max=1.5)
    theta0 = np.array([3.4e10, 8.0, 4.3, 0.7575])
    est_s = estimate_ncol_mle(lnlike, spec, theta0, (1e8, 1e14))
    est_b = estimate_ncol_mle(lnlike_b, spec, theta0, (1e8, 1e14),
                              batched=True)
    assert np.isclose(est_b, est_s, rtol=5e-3), (est_b, est_s)
