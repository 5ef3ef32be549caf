"""End-to-end default-scale MCMC fit on the dense aromatic stress catalog.

The dense analogue of the flagship HC5N full run. The reference's stress
case is the 35,460-transition 1-cyanonaphthalene catalog (reference
catalog/1-cyanonapthalene.cat — the reference's own spelling); its
pipeline never shipped an observation for it, so this tool synthesizes a
DSN-style spectrum with a weak LTE signal injected *below* the
reduction's 3.5-sigma interloper threshold (reference inference.py:279)
— the reference's own operating regime,
where individual lines are buried in noise and the constraint comes from
thousands of them jointly — then runs the standard SpectralFit pipeline
end-to-end at the reference's default scale (128 walkers x 10,000 steps,
reference inference.py:586-590): reduction, MLE Ncol init, auto-selected
sparse gather path.

Two subcommands (separate processes because the jax backend is fixed at
init: synth is host/CPU work, fit is the accelerator run):

  synth  — build the raw spectrum + injected signal; writes
           results/dense_full_fit/synthetic_obs.npy (gitignored, ~27 MB)
           and tests/golden/dense_synth.npz (committed: the reduced
           datagrid + truth sidecar so bench.py's dense_full_fit section
           can re-run the fit without the host reduction).
           Run with: JAX_PLATFORMS=cpu python tools/dense_full_fit.py synth
  fit    — the full pipeline run on the synthetic observation; writes
           chain + posterior.json under results/dense_full_fit/.
           Run with: python tools/dense_full_fit.py fit

Statistics fields are deterministic (fixed seeds); wall clock varies.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CAT_FOLDER = "/root/reference/catalog"
MOL = "1-cyanonapthalene"          # reference's spelling of the .cat file
DISH = 100.0                        # m, bench_dense convention (bench.py)
CENTER = 5.8                        # km/s aligned velocity
DF = 0.014                          # MHz raw channel width
NOISE = 1.0e-3                      # K rms, matches the bench dense yerrs
PEAK_SNR = 1.5                      # injected peak amplitude in noise sigmas
                                    # (< 3.5-sigma interloper threshold)
SEED_NOISE = 7
TRUTH = {"source_size": 52.0, "Tex": 8.0, "vlsr": 5.8, "dV": 0.7575}
BOUNDS = {"source_size": (30.0, 90.0), "Ncol": (1e8, 1e14),
          "Tex": (3.5, 12.0), "vlsr": (4.0, 7.5), "dV": (0.4, 1.5)}

OBS_PATH = os.path.join(REPO, "results", "dense_full_fit", "synthetic_obs.npy")
GOLDEN_PATH = os.path.join(REPO, "tests", "golden", "dense_synth.npz")
FIT_FOLDER = os.path.join(REPO, "results", "dense_full_fit")


def _host_forward(catalog, sel, grid_freq, *, Ncol, q_model=None):
    """Single-component LTE brightness on `grid_freq`, float64 NumPy.

    Mirrors models/forward.py:forward_from_lines (reference
    inference.py:44-61) with xp=np, chunked over lines so the (L, C)
    intermediate never materializes for the 1.7M-channel raw grid.
    simulate_gauss_host is NOT used: it reproduces the reference's
    MolSim(gauss=True) quirk of returning opacity rather than brightness
    (reference classes.py:377-385), which would be the wrong thing to
    inject as data.
    """
    from cha1_mcmc_tpu.catalogs.partition import q_model_for_catalog
    from cha1_mcmc_tpu.constants import (CKM, FWHM_TO_SIGMA_MODEL, T_CMB,
                                         VELOCITY_WINDOW_DV)
    from cha1_mcmc_tpu.ops.lte import beam_dilution, planck_J, tau_sticks

    if q_model is None:
        q_model = q_model_for_catalog(catalog)
    Tex, vlsr, dV = TRUTH["Tex"], TRUTH["vlsr"], TRUTH["dV"]
    Q = float(q_model(Tex))
    lf = catalog.frequency[sel]
    taus = tau_sticks(np, lf, catalog.elower[sel], catalog.aij[sel],
                      catalog.gup[sel], catalog.glow[sel],
                      Q, Ncol, Tex, dV)                       # (L,)
    sigma = dV / FWHM_TO_SIGMA_MODEL
    opac = np.zeros(grid_freq.shape[0])
    for s in range(0, lf.shape[0], 256):
        lfc = lf[s:s + 256, None]
        vel = (lfc - grid_freq[None, :]) / lfc * CKM + CENTER  # (l, C)
        window = np.abs(vel - CENTER) < VELOCITY_WINDOW_DV * dV
        z = (vel - vlsr) / sigma
        opac += np.einsum("l,lc->c", taus[s:s + 256],
                          np.where(window, np.exp(-0.5 * z * z), 0.0))
    J_T = planck_J(np, grid_freq, Tex, guard=1e-10)
    J_Tbg = planck_J(np, grid_freq, T_CMB, guard=1e-10)
    dil = beam_dilution(np, grid_freq, TRUTH["source_size"], DISH)
    return dil * (J_T - J_Tbg) * (1.0 - np.exp(-opac))


def synth():
    import jax

    jax.config.update("jax_platforms", "cpu")  # QModel dispatches via jnp

    from cha1_mcmc_tpu.catalogs import load_catalog
    from cha1_mcmc_tpu.reduce.datagrid import reduce_spectrum

    catalog = load_catalog(os.path.join(CAT_FOLDER, f"{MOL}.cat"), name=MOL)
    lo = float(catalog.frequency.min())
    hi = float(catalog.frequency.max())
    ll, ul = lo - 1.0, hi + 1.0
    nchan = int(np.ceil((ul - ll) / DF)) + 1
    freqs = ll + DF * np.arange(nchan)
    print(f"raw grid: {nchan:,} channels, {ll:.1f}-{ul:.1f} MHz")

    rng = np.random.default_rng(SEED_NOISE)
    ints = rng.standard_normal(nchan) * NOISE

    # Stage 1: noise-only selection with interloper blocking OFF — finds
    # every above-5%-threshold window (reference inference.py:272-275) so
    # the signal is injected at all of them; the fit's own reduction then
    # applies the honest 3.5-sigma interloper test to the injected data.
    t0 = time.perf_counter()
    grid0 = reduce_spectrum(catalog, _save_obs(freqs, ints), ll=ll, ul=ul,
                            aligned_velocity=CENTER, dish_size=DISH,
                            source_size=TRUTH["source_size"],
                            block_interlopers=False, verbose=False)
    print(f"stage-1 selection: {grid0.covered_trans.size:,} lines, "
          f"{grid0.freqs.size:,} channels ({time.perf_counter() - t0:.0f}s)")

    i, i2 = catalog.trim_indices(ll, ul)
    sel = np.arange(i, i2)[grid0.covered_trans]

    # Calibrate Ncol so the strongest channel sits at PEAK_SNR sigmas
    # (optically thin => intensity ~ linear in Ncol; one refinement pass).
    ncol = 1e12
    for _ in range(2):
        signal = _host_forward(catalog, sel, grid0.freqs, Ncol=ncol)
        ncol *= PEAK_SNR * NOISE / float(signal.max())
    signal = _host_forward(catalog, sel, grid0.freqs, Ncol=ncol)
    assert BOUNDS["Ncol"][0] < ncol < BOUNDS["Ncol"][1]
    print(f"calibrated Ncol_true = {ncol:.4e} "
          f"(peak {float(signal.max()) / NOISE:.2f} sigma)")

    idx = np.searchsorted(freqs, grid0.freqs)
    assert np.allclose(freqs[idx], grid0.freqs)
    ints[idx] += signal
    obs_path = _save_obs(freqs, ints)
    print(f"wrote {obs_path}")

    # Stage 2: the honest reduction of the injected spectrum — exactly what
    # SpectralFit.init_setup will do; committed as the bench fixture.
    t0 = time.perf_counter()
    grid = reduce_spectrum(catalog, obs_path, ll=ll, ul=ul,
                           aligned_velocity=CENTER, dish_size=DISH,
                           source_size=TRUTH["source_size"],
                           block_interlopers=True, verbose=False)
    blocked = grid0.covered_trans.size - grid.covered_trans.size
    print(f"stage-2 selection: {grid.covered_trans.size:,} lines covered, "
          f"{blocked} interloper-blocked, {grid.freqs.size:,} channels "
          f"({time.perf_counter() - t0:.0f}s)")

    os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
    np.savez_compressed(
        GOLDEN_PATH, freqs=grid.freqs, ints=grid.ints, yerrs=grid.yerrs,
        covered_trans=grid.covered_trans,
        ll=ll, ul=ul, dish_size=DISH, aligned_velocity=CENTER,
        ncol_true=ncol, noise=NOISE, peak_snr=PEAK_SNR,
        truth=np.array([ncol, TRUTH["Tex"], TRUTH["vlsr"], TRUTH["dV"]]),
        source_size=TRUTH["source_size"])
    print(f"wrote {GOLDEN_PATH} "
          f"({os.path.getsize(GOLDEN_PATH) / 1e6:.2f} MB)")


def _save_obs(freqs, ints):
    os.makedirs(os.path.dirname(OBS_PATH), exist_ok=True)
    np.save(OBS_PATH, np.stack([freqs, ints]))
    return OBS_PATH


def _golden_config(nruns, nwalkers, **overrides):
    from cha1_mcmc_tpu.pipeline.config import FitConfig

    g = np.load(GOLDEN_PATH)
    ncol = float(g["ncol_true"])
    kw = dict(
        mol_name=MOL, cat_folder=CAT_FOLDER, data_path=OBS_PATH,
        fit_folder=FIT_FOLDER, nruns=nruns, nwalkers=nwalkers,
        lower_limit=float(g["ll"]), upper_limit=float(g["ul"]),
        dish_size=float(g["dish_size"]),
        aligned_velocity=float(g["aligned_velocity"]),
        fixed_source_size=float(g["source_size"]),
        bounds=dict(BOUNDS),
        # Fiducial-style template priors (reference inference.py:602-603's
        # role): means at the assumed values, generous widths; MLE
        # re-initializes Ncol from the data exactly as the reference does.
        template_means=(float(g["source_size"]), 1.2 * ncol, 8.0, CENTER,
                        0.7575),
        template_stds=(6.5, 0.5 * ncol, 3.0, 0.06, 0.22),
        template_run=True, MLE_for_Ncol=True, seed=11,
        checkpoint_every=2000,
    )
    kw.update(overrides)
    return FitConfig(**kw), g


def _posterior_stats(chain, g, nruns, wall, sampler_name, acceptance):
    from cha1_mcmc_tpu.sampler.diagnostics import autocorr_time

    burn = nruns // 2
    post = chain[:, burn:, :].astype(np.float64)
    flat = post.reshape(-1, post.shape[-1])
    tau = autocorr_time(post)
    ess = post.shape[0] * post.shape[1] / tau
    truth = np.asarray(g["truth"], dtype=np.float64)
    mean, std = flat.mean(0), flat.std(0)
    z = (mean - truth) / np.maximum(std, 1e-30)
    labels = ["Ncol", "Tex", "vlsr", "dV"]
    out = {
        "catalog": MOL,
        "n_lines_covered": int(g["covered_trans"].size),
        "n_channels": int(g["freqs"].size),
        "nwalkers": int(chain.shape[0]), "nruns": int(nruns),
        "burn": int(burn), "sampler": sampler_name,
        "wall_seconds": round(wall, 1),
        "walker_steps_per_sec": round(chain.shape[0] * nruns / wall, 1),
        "acceptance": round(float(acceptance), 4),
        "truth": dict(zip(labels, truth.tolist())),
        "mean": dict(zip(labels, mean.tolist())),
        "std": dict(zip(labels, std.tolist())),
        "p16": dict(zip(labels, np.percentile(flat, 16, 0).tolist())),
        "p50": dict(zip(labels, np.percentile(flat, 50, 0).tolist())),
        "p84": dict(zip(labels, np.percentile(flat, 84, 0).tolist())),
        "tau": dict(zip(labels, tau.tolist())),
        "ess": dict(zip(labels, ess.tolist())),
        "recovery_z": dict(zip(labels, z.tolist())),
        "recovery_z_max": round(float(np.abs(z).max()), 3),
    }
    return out


def run_fit_from_datagrid(nruns=10_000, nwalkers=128, **overrides):
    """The fit phase alone, from the committed reduced datagrid — used by
    bench.py's dense_full_fit section so the driver never pays the host
    reduction. Returns the posterior-stats dict."""
    from cha1_mcmc_tpu.pipeline.fit import SpectralFit
    from cha1_mcmc_tpu.reduce.datagrid import Datagrid, save_datagrid

    cfg, g = _golden_config(nruns, nwalkers, **overrides)
    grid = Datagrid(freqs=np.asarray(g["freqs"], dtype=np.float64),
                    ints=np.asarray(g["ints"], dtype=np.float64),
                    yerrs=np.asarray(g["yerrs"], dtype=np.float64),
                    covered_trans=np.asarray(g["covered_trans"], dtype=int))
    fit = SpectralFit(cfg)
    os.makedirs(cfg.mol_folder, exist_ok=True)
    save_datagrid(cfg.datagrid_path, grid)
    t0 = time.perf_counter()
    chain = fit.fit(grid)
    wall = time.perf_counter() - t0
    return _posterior_stats(np.asarray(chain), g, nruns, wall,
                            type(fit.sampler).__name__,
                            fit.sampler.acceptance_fraction)


def fit_main(nruns=10_000, nwalkers=128):
    """The full end-to-end run: reduction from the raw synthetic
    observation (reference init_setup, inference.py:305-342), then the
    default-scale fit; posterior + plots under results/dense_full_fit/."""
    from cha1_mcmc_tpu.pipeline.fit import SpectralFit

    cfg, g = _golden_config(nruns, nwalkers)
    fit = SpectralFit(cfg)
    t0 = time.perf_counter()
    chain = fit.run()
    wall = time.perf_counter() - t0
    out = _posterior_stats(np.asarray(chain), g, nruns, wall,
                           type(fit.sampler).__name__,
                           fit.sampler.acceptance_fraction)
    out["wall_seconds_incl_reduction"] = round(wall, 1)
    path = os.path.join(FIT_FOLDER, "posterior.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)
    print(f"wrote {path}")
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    cmd = sys.argv[1] if len(sys.argv) > 1 else "synth"
    if cmd == "synth":
        synth()
    elif cmd == "fit":
        fit_main(nruns=int(sys.argv[2]) if len(sys.argv) > 2 else 10_000)
    else:
        raise SystemExit(f"unknown subcommand {cmd!r} (synth|fit)")
