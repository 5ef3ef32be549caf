"""End-to-end pipeline tests: short seeded fits, determinism, config
translation, posterior statistical parity."""

import contextlib
import io
import os

import numpy as np
import pytest

from cha1_mcmc_tpu import FitConfig, SpectralFit
from tests.conftest import requires_reference, CATALOG_DIR


def _config(inputs, tmp_path, **kw):
    base = dict(
        mol_name="hc5n_hfs", template_run=True, nruns=60, nwalkers=32,
        cat_folder=inputs[0], data_path=inputs[1],
        fit_folder=str(tmp_path / "results"), seed=0, checkpoint_every=30,
        MLE_for_Ncol=False)
    base.update(kw)
    return FitConfig(**base)


def test_end_to_end_short_fit(hc5n_inputs, tmp_path):
    cfg = _config(hc5n_inputs, tmp_path)
    fit = SpectralFit(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        chain = fit.run()
    assert chain.shape == (32, 60, 4)
    assert os.path.exists(cfg.chain_path)
    assert os.path.exists(cfg.chain_path[:-4] + "_corner.png")
    assert os.path.exists(os.path.join(cfg.mol_folder, "config.json"))
    saved = np.load(cfg.chain_path)
    np.testing.assert_array_equal(saved, chain)
    # all samples respect the box bounds
    assert saved[..., 0].min() > 1e8 and saved[..., 0].max() < 1e14
    assert saved[..., 1].min() > 3.5 and saved[..., 1].max() < 12.0


def test_end_to_end_deterministic(hc5n_inputs, tmp_path):
    chains = []
    for run in range(2):
        cfg = _config(hc5n_inputs, tmp_path / f"run{run}")
        with contextlib.redirect_stdout(io.StringIO()):
            chains.append(SpectralFit(cfg).run())
    np.testing.assert_array_equal(chains[0], chains[1])


def test_posterior_as_prior_refit(hc5n_inputs, tmp_path):
    """Template run -> non-template run chained from its posterior
    (reference inference.py:388-419)."""
    cfg = _config(hc5n_inputs, tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        SpectralFit(cfg).run()
    cfg2 = _config(hc5n_inputs, tmp_path, template_run=False, nruns=30,
                   prior_path=cfg.chain_path)
    with contextlib.redirect_stdout(io.StringIO()):
        chain2 = SpectralFit(cfg2).run()
    assert chain2.shape == (32, 30, 4)
    assert os.path.basename(cfg2.chain_path) == "chain.npy"
    assert os.path.exists(cfg2.chain_path)


def test_sharded_pipeline_end_to_end(hc5n_inputs, tmp_path):
    """FitConfig.n_devices routes the fit through the multi-chip sampler
    with the full chain-file + state-sidecar contract (the device-mesh
    replacement for the reference's parallelize flag, inference.py:456-463)."""
    cfg = _config(hc5n_inputs, tmp_path, n_devices=8, n_line_shards=2, nwalkers=16,
                  nruns=30, checkpoint_every=10)
    fit = SpectralFit(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        chain = fit.run()
    assert chain.shape == (16, 30, 4)
    assert os.path.exists(cfg.chain_path)
    assert os.path.exists(cfg.chain_path[:-4] + ".state.npz")
    saved = np.load(cfg.chain_path)
    np.testing.assert_array_equal(saved, chain)
    assert 0.05 < fit.sampler.acceptance_fraction < 0.95
    assert np.isfinite(fit.sampler.lnprobability).all()
    # samples respect the box bounds
    assert saved[..., 1].min() > 3.5 and saved[..., 1].max() < 12.0


def test_sharded_exact_resume(hc5n_inputs, tmp_path):
    """A sharded run interrupted at a checkpoint and resumed via the state
    sidecar reproduces the uninterrupted sharded chain bit for bit."""
    base = dict(mol_name="hc5n_hfs", template_run=True, nwalkers=16,
                cat_folder=hc5n_inputs[0], data_path=hc5n_inputs[1], seed=3,
                checkpoint_every=10, MLE_for_Ncol=False, n_devices=8)
    cfg_full = FitConfig(nruns=20, fit_folder=str(tmp_path / "full"), **base)
    with contextlib.redirect_stdout(io.StringIO()):
        chain_full = SpectralFit(cfg_full).run()
    cfg_a = FitConfig(nruns=10, fit_folder=str(tmp_path / "split"), **base)
    with contextlib.redirect_stdout(io.StringIO()):
        SpectralFit(cfg_a).run()
    cfg_b = FitConfig(nruns=10, resume=True,
                      fit_folder=str(tmp_path / "split"), **base)
    with contextlib.redirect_stdout(io.StringIO()):
        chain_split = SpectralFit(cfg_b).run()
    np.testing.assert_array_equal(chain_full, chain_split)


def test_reference_config_dict_translates(hc5n_inputs, tmp_path):
    """A reference-style config dict maps onto FitConfig 1:1
    (reference inference.py:585-631)."""
    ref_style = {
        "mol_name": "hc5n_hfs",
        "template_run": True,
        "nruns": 10,
        "nwalkers": 16,
        "bounds": {
            "source_size": [30.0, 90.0], "Ncol": [1e8, 1e14],
            "Tex": [3.5, 12.0], "vlsr": [3.0, 5.5], "dV": [0.4, 1.5]},
        "template_means": np.array([46.91, 3.4e10, 8.0, 4.3, 0.7575]),
        "template_stds": np.array([6.5, 0.34e10, 3.0, 0.06, 0.22]),
        "dish_size": 70, "lower_limit": 18000, "upper_limit": 25000,
        "aligned_velocity": 4.10, "fixed_source_size": 52.0,
        "MLE_for_Ncol": False, "block_interlopers": True, "parallelize": True,
        "fit_folder": str(tmp_path / "results"),
        "cat_folder": hc5n_inputs[0],
        "prior_path": None,
        "data_paths": {"hc5n_hfs": hc5n_inputs[1]},
        "use_fused_step": True,  # an option of older configs: ignored
    }
    cfg = FitConfig.from_dict(ref_style)
    assert cfg.data_path == hc5n_inputs[1]
    assert cfg.ndim == 4
    # source-size prior entries stripped when fixed (reference :634-636)
    assert len(cfg.template_means) == 4
    assert cfg.template_means[0] == pytest.approx(3.4e10)


def test_mle_init_shifts_ncol(hc5n_inputs, tmp_path):
    cfg = _config(hc5n_inputs, tmp_path, MLE_for_Ncol=True, nruns=10)
    fit = SpectralFit(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        grid = fit.init_setup()
        fit.fit(grid)
    # MLE moves Ncol from the template mean 3.4e10 to the ~3e12 basin
    first_step = fit.sampler.chain[:, 0, 0]
    assert np.median(first_step) > 1e12


def test_multichain_pipeline(hc5n_inputs, tmp_path, capsys):
    """FitConfig.n_chains runs independent ensembles with a cross-chain
    R-hat report and the standard chain-file contract."""
    cfg = _config(hc5n_inputs, tmp_path, n_chains=4, nwalkers=64, nruns=200,
                  checkpoint_every=100, MLE_for_Ncol=True)
    fit = SpectralFit(cfg)
    chain = fit.run()
    out = capsys.readouterr().out
    assert "Cross-chain R-hat (4 chains)" in out
    assert chain.shape == (64, 200, 4)
    saved = np.load(cfg.chain_path)
    np.testing.assert_array_equal(saved, chain)
    # chains are genuinely independent: walkers 0-15 (chain 0) never see
    # walkers 16-31 (chain 1), so their seeded histories differ
    assert not np.array_equal(chain[:16], chain[16:32])


def test_float64_mode_is_scoped(hc5n_inputs, tmp_path):
    """dtype="float64" runs the fit in full precision *without* flipping
    the process-global jax_enable_x64 flag (round-1 weak spot: the
    constructor mutated interpreter-wide state)."""
    import jax

    assert not jax.config.jax_enable_x64
    cfg = _config(hc5n_inputs, tmp_path, dtype="float64", nruns=20, nwalkers=16,
                  checkpoint_every=20)
    fit = SpectralFit(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        grid = fit.init_setup()
        chain = fit.fit(grid)
    assert chain.dtype == np.float64
    assert not jax.config.jax_enable_x64  # no global leak
    # f32 default still works in the same process afterwards
    cfg2 = _config(hc5n_inputs, tmp_path, nruns=5, nwalkers=16, checkpoint_every=5,
                   fit_folder=str(tmp_path / "f32"))
    with contextlib.redirect_stdout(io.StringIO()):
        chain2 = SpectralFit(cfg2).run()
    assert chain2.dtype == np.float32


@requires_reference
@pytest.mark.slow
def test_posterior_statistical_parity(tmp_path):
    """The 1% same-data parity gate against the reference's own lnprob.

    The golden posterior (tests/golden/hc5n_reference_posterior.json,
    regenerable via tools/make_reference_posterior.py) samples the
    *reference's own* lnprob stack — executed in place from
    /root/reference via tests/reference_oracle.py — on the shipped HC5N
    Cha-MMS1 spectrum with a NumPy emcee-v3 stretch move for 512 x 40k
    steps. This test runs the full device pipeline (reduction -> MLE ->
    jitted lax.scan sampler) on the same data at the same size and
    requires every posterior mean and 16/50/84 percentile within 1%, and
    every std within max(1%, 3 sigma of the comparison's Monte-Carlo
    error) — the MC error per side is sqrt((kurtosis-1)/(4 ESS)), both
    measured; with ESS ~ 120k/side it exceeds 1%/3 only for Ncol, whose
    posterior is heavy-tailed (kurtosis ~ 9.7, tau ~ 154).

    Replaces the published-number check: the published best fit
    (reference notebooks/DSN_spectra.ipynb cell 7) came from an unshipped
    "rereduced" spectrum (reference inference.py:623) and can only gate
    at 15-25%; the same-data golden gates at the north star."""
    import json

    golden_path = os.path.join(os.path.dirname(__file__), "golden",
                               "hc5n_reference_posterior.json")
    with open(golden_path) as fh:
        golden = json.load(fh)
    nwalkers = golden["provenance"]["nwalkers"]
    burn = golden["provenance"]["burn"]

    cfg = _config(hc5n_inputs, tmp_path, nruns=40_000, nwalkers=nwalkers,
                  MLE_for_Ncol=True, checkpoint_every=40_000)
    fit = SpectralFit(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        chain = fit.run()
    # f64 for the *statistics*: a naive f32 mean over millions of samples
    # loses ~2% once the accumulator saturates (the chain itself is f32 —
    # only the reduction needs widening).
    flat = chain[:, burn:, :].reshape(-1, 4).astype(np.float64)

    stats = {
        "mean": flat.mean(axis=0),
        "std": flat.std(axis=0),
        "p16": np.percentile(flat, 16, axis=0),
        "p50": np.percentile(flat, 50, axis=0),
        "p84": np.percentile(flat, 84, axis=0),
    }
    for stat, ours in stats.items():
        for i, p in enumerate(golden["params"]):
            ref = golden[stat][p]
            rtol = 0.01
            if stat == "std":
                # two independent MC estimates of a posterior std differ
                # by sigma = sqrt(sum over sides of (kappa-1)/(4 ESS));
                # gate at 3 sigma when that exceeds 1%. Fallbacks cover a
                # pre-regeneration golden without the diagnostics fields
                # (values measured on a 128x40k pipeline chain).
                kap = golden.get("kurtosis", {"Ncol": 9.7, "Tex": 2.0,
                                              "vlsr": 3.5, "dV": 3.0})[p]
                tau = golden.get("tau", {"Ncol": 154.0, "Tex": 98.0,
                                         "vlsr": 54.0, "dV": 57.0})[p]
                ess = golden.get("ess", {}).get(
                    p, nwalkers * (40_000 - burn) / tau)
                sigma = np.sqrt(2 * (kap - 1) / (4 * ess))
                rtol = max(0.01, 3 * sigma)
            assert np.isclose(ours[i], ref, rtol=rtol), (
                f"{stat}[{p}]: ours={ours[i]:.6e} ref={ref:.6e} "
                f"rel={abs(ours[i] - ref) / abs(ref):.4f} (rtol {rtol:.4f})")


@requires_reference
def test_multicomponent_gotham_fit(tmp_path):
    """Short 4-component GOTHAM fit end-to-end (template run)."""
    from cha1_mcmc_tpu import MultiFitConfig, MultiComponentFit
    from tests.conftest import HC9N_GOTHAM

    cfg = MultiFitConfig(
        mol_name="hc9n_hfs", cat_folder=CATALOG_DIR, data_path=HC9N_GOTHAM,
        fit_folder=str(tmp_path / "gotham"), nruns=40, nwalkers=32,
        template_run=True, seed=0, checkpoint_every=20)
    fit = MultiComponentFit(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        chain = fit.run()
    assert chain.shape == (32, 40, 14)
    assert os.path.exists(cfg.chain_path)
    # velocity ordering holds for every accepted sample with finite lnp
    lnp = fit.sampler.lnprobability
    vlsr = chain[..., 9:13]
    finite = np.isfinite(lnp)
    assert finite.any()
    d = np.diff(vlsr[finite], axis=-1)
    assert (d > 0.05 - 1e-9).all()


@requires_reference
def test_multicomponent_sharded_fit(tmp_path):
    """The widest model (14-dim, 4 components) end-to-end over a
    (2 walkers x 2 lines) mesh — the sharded runner is ncomp-generic."""
    from cha1_mcmc_tpu import MultiFitConfig, MultiComponentFit
    from tests.conftest import HC9N_GOTHAM

    cfg = MultiFitConfig(
        mol_name="hc9n_hfs", cat_folder=CATALOG_DIR, data_path=HC9N_GOTHAM,
        fit_folder=str(tmp_path / "gotham_sh"), nruns=40, nwalkers=32,
        template_run=True, seed=0, checkpoint_every=20,
        n_devices=4, n_line_shards=2)
    fit = MultiComponentFit(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        chain = fit.run()
    assert chain.shape == (32, 40, 14)
    lnp = fit.sampler.lnprobability
    finite = np.isfinite(lnp)
    assert finite.any()
    # ordered-velocity prior holds on every finite-lnp sample
    d = np.diff(chain[..., 9:13][finite], axis=-1)
    assert (d > 0.05 - 1e-9).all()


@requires_reference
def test_multicomponent_continue_from_chain(tmp_path):
    """restart=False resumes from the median of the last 200 steps
    (reference TMC1_four_component.py:325-327)."""
    from cha1_mcmc_tpu import MultiFitConfig, MultiComponentFit
    from tests.conftest import HC9N_GOTHAM

    base = dict(mol_name="hc9n_hfs", cat_folder=CATALOG_DIR, data_path=HC9N_GOTHAM,
                fit_folder=str(tmp_path / "gotham"), nwalkers=32, seed=0,
                checkpoint_every=30)
    cfg = MultiFitConfig(nruns=30, template_run=True, **base)
    with contextlib.redirect_stdout(io.StringIO()):
        MultiComponentFit(cfg).run()
    cfg2 = MultiFitConfig(nruns=10, template_run=False, restart=False,
                          prior_path=cfg.chain_path, **base)
    with contextlib.redirect_stdout(io.StringIO()):
        chain2 = MultiComponentFit(cfg2).run()
    assert chain2.shape == (32, 10, 14)


@requires_reference
def test_one_component_gotham_fit(tmp_path):
    """ncomp=1 covers the reference's TMC1_one_component variant
    (reference scripts/MCMC/TMC1_one_component.py: 5-dim theta, GOTHAM
    reduction, ordered-velocity prior degenerates to plain bounds)."""
    from cha1_mcmc_tpu import MultiFitConfig, MultiComponentFit
    from tests.conftest import HC9N_GOTHAM

    cfg = MultiFitConfig(
        mol_name="hc9n_hfs", cat_folder=CATALOG_DIR, data_path=HC9N_GOTHAM,
        fit_folder=str(tmp_path / "g1"), nruns=20, nwalkers=16, ncomp=1,
        template_run=True, seed=0, checkpoint_every=10,
        template_means=(37.0, 2.47e12, 6.7, 5.79, 0.117),
        template_stds=(2.5, 0.3e12, 0.1, 0.002, 0.002),
        perturbation=(1e-1, 1e10, 1e-3, 1e-3, 1e-3))
    with contextlib.redirect_stdout(io.StringIO()):
        chain = MultiComponentFit(cfg).run()
    assert chain.shape == (16, 20, 5)
    assert np.isfinite(chain).all()


@requires_reference
def test_two_component_gotham_fit(tmp_path):
    """ncomp=2 — a component count the reference never shipped a script
    for (it has only 1- and 4-component variants, scripts/MCMC/): the
    ParamSpec parameterization is ncomp-generic (theta = [2x ss, 2x Ncol,
    Tex, 2x ordered vlsr, dV] = 8-dim), so intermediate source models
    need no new code path."""
    from cha1_mcmc_tpu import MultiFitConfig, MultiComponentFit
    from tests.conftest import HC9N_GOTHAM

    cfg = MultiFitConfig(
        mol_name="hc9n_hfs", cat_folder=CATALOG_DIR, data_path=HC9N_GOTHAM,
        fit_folder=str(tmp_path / "g2"), nruns=20, nwalkers=16, ncomp=2,
        template_run=True, seed=0, checkpoint_every=10,
        template_means=(37.0, 31.0, 2.47e12, 2.8e12, 6.7, 5.60, 5.79, 0.117),
        template_stds=(2.5, 2.5, 0.3e12, 0.3e12, 0.1, 0.002, 0.002, 0.002),
        perturbation=(1e-1, 1e-1, 1e10, 1e10, 1e-3, 1e-3, 1e-3, 1e-3))
    with contextlib.redirect_stdout(io.StringIO()):
        chain = MultiComponentFit(cfg).run()
    assert chain.shape == (16, 20, 8)
    assert np.isfinite(chain).all()
    # the ordered-velocity prior holds for the sampled 2-component chain:
    # vlsr_1 < vlsr_2 for every retained walker step
    vl = chain[:, :, 5:7]
    assert (vl[..., 0] < vl[..., 1]).all()


def test_batch_fit_molecules(hc5n_inputs, tmp_path):
    """fit_molecules runs every molecule in the mapping, with round-robin
    process sharding."""
    from cha1_mcmc_tpu.pipeline.batch import fit_molecules

    base = _config(hc5n_inputs, tmp_path, nruns=10, nwalkers=16)
    paths = {"hc5n_hfs": hc5n_inputs[1]}
    with contextlib.redirect_stdout(io.StringIO()):
        results = fit_molecules(base, paths)
    assert set(results) == {"hc5n_hfs"}
    assert results["hc5n_hfs"].shape == (16, 10, 4)
    # a second process index gets nothing for a 1-molecule batch
    with contextlib.redirect_stdout(io.StringIO()):
        empty = fit_molecules(base, paths, process_index=1, process_count=2)
    assert empty == {}


@requires_reference
@pytest.mark.parametrize("mol", ["hc7n_hfs", "hc11n", "benzonitrile"])
def test_multifit_other_gotham_datasets(tmp_path, mol):
    """Every pre-reduced GOTHAM datagrid the reference ships (not just
    hc9n_hfs) runs through the 14-dim multifit pipeline — different
    catalogs, line counts (19-153 covered) and channel counts, through
    the sparse gather opacity default."""
    from cha1_mcmc_tpu import MultiFitConfig, MultiComponentFit
    from tests.conftest import REFERENCE_ROOT

    cfg = MultiFitConfig(
        mol_name=mol, cat_folder=f"{REFERENCE_ROOT}/catalog",
        data_path=f"{REFERENCE_ROOT}/data/GOTHAM/{mol}_chunks.npy",
        fit_folder=str(tmp_path), nruns=2, nwalkers=16,
        template_run=True, seed=0, checkpoint_every=2)
    fit = MultiComponentFit(cfg)
    grid = fit.init_setup()
    chain = fit.fit(grid)
    assert chain.shape == (16, 2, 14)
    assert np.isfinite(np.asarray(fit.sampler.lnprobability)).all()


def test_enable_compilation_cache(tmp_path):
    """The persistent-compile-cache helper (utils/compile_cache.py): a
    directory the user configured (JAX_COMPILATION_CACHE_DIR, which JAX
    reads into jax_compilation_cache_dir) is left untouched; otherwise the
    fixed in-checkout default is created and set."""
    import jax

    from cha1_mcmc_tpu.utils import enable_compilation_cache
    from cha1_mcmc_tpu.utils.compile_cache import DEFAULT_CACHE_DIR

    prev = jax.config.jax_compilation_cache_dir
    try:
        user_dir = str(tmp_path / "user")
        jax.config.update("jax_compilation_cache_dir", user_dir)
        assert enable_compilation_cache() == user_dir
        assert jax.config.jax_compilation_cache_dir == user_dir

        jax.config.update("jax_compilation_cache_dir", None)
        assert enable_compilation_cache() == DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == DEFAULT_CACHE_DIR
        assert os.path.isdir(DEFAULT_CACHE_DIR)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert os.path.dirname(DEFAULT_CACHE_DIR) == repo
        # idempotent: a second call keeps the same directory
        assert enable_compilation_cache() == DEFAULT_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


@pytest.mark.parametrize("fit_kind,kw,sampler_name,batched", [
    ("single", {}, "EnsembleSampler", False),
    ("single", {"use_pallas": True}, "EnsembleSampler", True),
    ("single", {"n_chains": 2}, "MultiChainSampler", False),
    ("multi", {}, "EnsembleSampler", True),
    ("multi", {"n_chains": 2}, "MultiChainSampler", True),
])
def test_device_selection_on_gpu_platform(hc5n_inputs, tmp_path, monkeypatch,
                                          fit_kind, kw, sampler_name,
                                          batched):
    """On a "gpu" platform SpectralFit / MultiComponentFit build the
    general samplers over the jnp lnprob builders, and never a Pallas
    program: the package has no kernel or branch chosen by platform."""
    import pathlib

    import jax
    from jax.experimental import pallas

    from cha1_mcmc_tpu import MultiComponentFit, MultiFitConfig

    def no_pallas(*args, **kwargs):
        raise AssertionError("a Pallas program was built")

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(pallas, "pallas_call", no_pallas)
    package = pathlib.Path(__file__).resolve().parents[1] / "cha1_mcmc_tpu"
    assert not [p for p in package.rglob("*.py")
                if "pallas" in p.read_text().replace("use_pallas", "")]

    if fit_kind == "single":
        cfg = _config(hc5n_inputs, tmp_path, nruns=4, nwalkers=16,
                      checkpoint_every=4, **kw)
        fit = SpectralFit(cfg)
    else:
        cfg = MultiFitConfig(
            mol_name="hc5n_hfs", cat_folder=hc5n_inputs[0],
            data_path=hc5n_inputs[1], fit_folder=str(tmp_path / "multi"),
            nruns=4, nwalkers=16, template_run=True, seed=0,
            checkpoint_every=4, **kw)
        fit = MultiComponentFit(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        chain = fit.fit(fit.init_setup())
    assert type(fit.sampler).__name__ == sampler_name
    assert fit.sampler.batched is batched
    assert chain.shape[:2] == (16, 4)


@requires_reference
@pytest.mark.slow
def test_posterior_statistical_parity_gotham(tmp_path):
    """The 1% same-data parity gate for the WIDEST model: 14-dim
    4-component GOTHAM TMC-1.

    The golden posterior (tests/golden/gotham_reference_posterior.json,
    regenerable via tools/make_reference_posterior_gotham.py) samples the
    *reference's own* frozen TMC-1 lnprob stack — executed in place from
    /root/reference/scripts/MCMC/TMC1_four_component.py — on the shipped
    hc9n_hfs GOTHAM datagrid with a NumPy emcee-v3 stretch move. This
    test runs the full multifit pipeline (GOTHAM reduction -> batched
    gather lnprob -> jitted sampler) at the same size and requires every
    posterior mean and 16/50/84 percentile within 1%, and every std
    within max(1%, 3 sigma of the two-sided Monte-Carlo error) — the
    same tolerance scheme as the HC5N gate above."""
    import json

    from cha1_mcmc_tpu import MultiFitConfig, MultiComponentFit
    from cha1_mcmc_tpu.sampler.diagnostics import autocorr_time
    from tests.conftest import HC9N_GOTHAM

    golden_path = os.path.join(os.path.dirname(__file__), "golden",
                               "gotham_reference_posterior.json")
    if not os.path.exists(golden_path):
        pytest.skip("golden GOTHAM posterior not generated yet "
                    "(tools/make_reference_posterior_gotham.py)")
    with open(golden_path) as fh:
        golden = json.load(fh)
    nwalkers = golden["provenance"]["nwalkers"]
    nsteps = golden["provenance"]["nsteps"]
    burn = golden["provenance"]["burn"]

    cfg = MultiFitConfig(
        mol_name="hc9n_hfs", cat_folder=CATALOG_DIR, data_path=HC9N_GOTHAM,
        fit_folder=str(tmp_path / "gotham_parity"), nruns=nsteps,
        nwalkers=nwalkers, template_run=True, seed=3,
        checkpoint_every=nsteps)
    fit = MultiComponentFit(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        chain = fit.run()
    flat = chain[:, burn:, :].reshape(-1, 14).astype(np.float64)

    # my side's MC-error ingredients (for the std tolerance)
    my_tau = autocorr_time(chain[:, burn:, :].astype(np.float64))
    my_ess = chain.shape[0] * (nsteps - burn) / my_tau
    my_kurt = np.mean(((flat - flat.mean(0)) / flat.std(0)) ** 4, axis=0)

    stats = {
        "mean": flat.mean(axis=0),
        "std": flat.std(axis=0),
        "p16": np.percentile(flat, 16, axis=0),
        "p50": np.percentile(flat, 50, axis=0),
        "p84": np.percentile(flat, 84, axis=0),
    }
    for stat, ours in stats.items():
        for i, p in enumerate(golden["params"]):
            ref = golden[stat][p]
            rtol = 0.01
            if stat == "std":
                # two independent MC estimates of a posterior std differ
                # by sigma = sqrt(sum over sides of (kappa-1)/(4 ESS))
                var = sum((k - 1) / (4 * e) for k, e in
                          [(golden["kurtosis"][p], golden["ess"][p]),
                           (float(my_kurt[i]), float(my_ess[i]))])
                rtol = max(0.01, 3 * np.sqrt(var))
            assert np.isclose(ours[i], ref, rtol=rtol), (
                f"{stat}[{p}]: ours={ours[i]:.6e} ref={ref:.6e} "
                f"rel={abs(ours[i] - ref) / abs(ref):.4f} (rtol {rtol:.4f})")


@requires_reference
def test_multicomponent_multichain_fit(tmp_path):
    """MultiFitConfig(n_chains=K): K independent 14-dim ensembles pooled
    into one chain file, cross-chain R-hat printed — the multifit
    analogue of FitConfig.n_chains."""
    from cha1_mcmc_tpu import MultiFitConfig, MultiComponentFit
    from tests.conftest import HC9N_GOTHAM

    cfg = MultiFitConfig(
        mol_name="hc9n_hfs", cat_folder=CATALOG_DIR, data_path=HC9N_GOTHAM,
        fit_folder=str(tmp_path / "gotham_mc"), nruns=20, nwalkers=32,
        template_run=True, seed=0, checkpoint_every=20, n_chains=2)
    fit = MultiComponentFit(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        chain = fit.run()
    assert chain.shape == (32, 20, 14)
    per_chain = chain.reshape(2, 16, 20, 14)
    assert not np.array_equal(per_chain[0], per_chain[1])
    assert 0.05 < fit.sampler.acceptance_fraction < 0.95


@requires_reference
def test_dense_full_fit_smoke(tmp_path):
    """The dense full-fit artifact path (tools/dense_full_fit.py): the
    committed reduced datagrid of the synthetic
    1-cyanonaphthalene observation (tests/golden/dense_synth.npz) drives
    the standard SpectralFit machinery. Subset to the bottom ~3 GHz of the
    band so the CPU run stays fast — the full-scale 128x10k run is the
    bench.py dense_full_fit section.

    Reference trail: catalog/1-cyanonapthalene.cat is the reference's
    stress catalog; the config vocabulary is inference.py:585-631."""
    from cha1_mcmc_tpu.catalogs import load_catalog
    from cha1_mcmc_tpu.reduce.datagrid import Datagrid

    golden_path = os.path.join(os.path.dirname(__file__), "golden",
                               "dense_synth.npz")
    g = np.load(golden_path)
    # sidecar integrity: the fields the tool and bench section rely on
    for key in ("freqs", "ints", "yerrs", "covered_trans", "ll", "ul",
                "dish_size", "aligned_velocity", "ncol_true", "truth",
                "source_size"):
        assert key in g, key
    assert g["freqs"].shape == g["ints"].shape == g["yerrs"].shape
    assert 1e8 < float(g["ncol_true"]) < 1e14

    cat = load_catalog(os.path.join(CATALOG_DIR, "1-cyanonapthalene.cat"))
    ll, ul = float(g["ll"]), float(g["ul"])
    i, i2 = cat.trim_indices(ll, ul)
    trimfreq = cat.frequency[np.arange(i, i2)]
    covered = np.asarray(g["covered_trans"], dtype=int)
    # channels below 9 GHz; kept lines 5 MHz clear of the cut so no kept
    # window loses channels
    F = 10500.0
    keep = covered[trimfreq[covered] < F - 5.0]
    chmask = g["freqs"] < F
    assert keep.size > 50 and chmask.sum() > 500
    grid = Datagrid(freqs=np.asarray(g["freqs"])[chmask],
                    ints=np.asarray(g["ints"])[chmask],
                    yerrs=np.asarray(g["yerrs"])[chmask],
                    covered_trans=keep)

    ncol = float(g["ncol_true"])
    cfg = FitConfig(
        mol_name="1-cyanonapthalene", cat_folder=CATALOG_DIR,
        fit_folder=str(tmp_path / "dense"), nruns=40, nwalkers=16,
        lower_limit=ll, upper_limit=ul, dish_size=float(g["dish_size"]),
        aligned_velocity=float(g["aligned_velocity"]),
        fixed_source_size=float(g["source_size"]),
        bounds={"source_size": (30.0, 90.0), "Ncol": (1e8, 1e14),
                "Tex": (3.5, 12.0), "vlsr": (4.0, 7.5), "dV": (0.4, 1.5)},
        template_means=(float(g["source_size"]), 1.2 * ncol, 8.0, 5.8,
                        0.7575),
        template_stds=(6.5, 0.5 * ncol, 3.0, 0.06, 0.22),
        template_run=True, MLE_for_Ncol=True, seed=5, checkpoint_every=40)
    fit = SpectralFit(cfg)
    os.makedirs(cfg.mol_folder, exist_ok=True)
    with contextlib.redirect_stdout(io.StringIO()):
        chain = np.asarray(fit.fit(grid))
    assert chain.shape == (16, 40, 4)
    assert np.isfinite(chain).all()
    assert chain[..., 0].min() > 1e8 and chain[..., 0].max() < 1e14
    assert 0.0 < fit.sampler.acceptance_fraction <= 1.0


@requires_reference
def test_multifit_attaches_cheb_q_for_state_sum():
    """The multifit pipeline attaches the device Chebyshev Q surrogate to
    state-sum molecules (the same optimization SpectralFit.build_model
    applies — the exact sum is a (walkers x states) exp per
    evaluation), sizing the fit interval from the
    ACTUAL Tex prior since the multifit prior box has no hard upper
    bound (reference TMC1_four_component.py bounds Tex below only)."""
    import numpy as np
    from cha1_mcmc_tpu import MultiFitConfig, MultiComponentFit
    from cha1_mcmc_tpu.catalogs import load_catalog
    from cha1_mcmc_tpu.models.forward import SpectralModel

    cfg = MultiFitConfig(mol_name="cyclopentadiene", cat_folder=CATALOG_DIR,
                         ncomp=4)
    fit = MultiComponentFit(cfg)
    catalog = load_catalog(cfg.catfile_path)
    lo = float(catalog.frequency.min())
    hi = float(catalog.frequency.max())
    model = SpectralModel.build(
        catalog, np.array([0, 1]), np.linspace(lo, lo + 50.0, 64),
        ll=lo - 10, ul=hi + 10, dish_size=100.0,
        vel_offset=0.0, mask_center=5.8)
    assert model.q_model.kind == "states"

    means = np.asarray(cfg.template_means, dtype=np.float64)
    stds = np.asarray(cfg.template_stds, dtype=np.float64)
    got = fit._attach_device_q(model, means, stds)
    qm = got.q_model
    assert qm.cheb_coeffs is not None
    t_lo, t_hi = qm.cheb_interval
    assert t_lo == 2.7 and t_hi >= 60.0
    # surrogate matches the exact reference state sum across the interval
    T = np.linspace(t_lo, t_hi, 257)
    np.testing.assert_allclose(np.asarray(qm(T)), qm.host_eval(T),
                               rtol=5e-7)
    # host/f64 oracle path untouched
    assert qm.host_eval(10.0) == model.q_model.host_eval(10.0)
    # analytic models pass through unchanged
    hc9n = load_catalog(os.path.join(CATALOG_DIR, "hc9n_hfs.cat"))
    model2 = SpectralModel.build(
        hc9n, np.array([0, 1]), np.linspace(20000.0, 20050.0, 64),
        ll=7000, ul=30000, dish_size=100.0, vel_offset=0.0,
        mask_center=5.8)
    assert fit._attach_device_q(model2, means, stds) is model2
