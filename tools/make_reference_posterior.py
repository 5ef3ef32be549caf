"""Generate the golden same-data reference posterior for the 1% parity gate.

Samples the reference's own lnprob stack (executed in place from
/root/reference via tests/reference_oracle.py) on the *shipped* HC5N
Cha-MMS1 spectrum with a NumPy implementation of the emcee v3 stretch move
(the move the reference drives via emcee==3.1.6, reference
inference.py:455-473), long enough that the Monte-Carlo error of every
posterior mean and std is well below 1% (ESS >~ 40k per dimension).

Writes tests/golden/hc5n_reference_posterior.json. The statistics fields
are deterministic (fixed seeds), so re-running reproduces them exactly;
the wall_seconds provenance field varies run to run.

Usage:  JAX_PLATFORMS=cpu python tools/make_reference_posterior.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

NWALKERS = 512
NSTEPS = 40_000
BURN = 4_000
SEED_INIT = 0
SEED_CHAIN = 1
PARAMS = ["Ncol", "Tex", "vlsr", "dV"]


def main():
    from tests import reference_oracle
    from tests.conftest import HC5N_CAT, HC5N_DATA
    from tests.test_convergence import _numpy_stretch_sampler
    from cha1_mcmc_tpu.catalogs import load_catalog
    from cha1_mcmc_tpu.reduce.datagrid import reduce_spectrum

    classes, _, inference = reference_oracle.load_reference()
    fitter = reference_oracle.make_reference_fitter(inference)
    mol_cat = classes.MolCat("hc5n_hfs", HC5N_CAT)

    # Reduction is byte-identical to the reference's init_setup
    # (tests/test_reduction.py golden test), so either implementation
    # yields the same datagrid; ours avoids the reference's file side
    # effects.
    catalog = load_catalog(HC5N_CAT)
    grid = reduce_spectrum(
        catalog, HC5N_DATA, ll=18000, ul=25000, aligned_velocity=4.10,
        dish_size=70, source_size=52.0, block_interlopers=True, verbose=False)
    ref_grid = grid.as_object_array()

    means = np.array([3.4e10, 8.0, 4.3, 0.7575])
    stds = np.array([0.34e10, 3.0, 0.06, 0.22])

    def lnprob_ref(theta):
        return fitter.lnprob(theta, ref_grid, mol_cat, stds, means)

    rng = np.random.default_rng(SEED_INIT)
    pos0 = np.array([3.24e12, 7.5, 4.11, 0.78]) * (
        1 + 0.01 * rng.standard_normal((NWALKERS, 4)))

    t0 = time.perf_counter()
    chain = _numpy_stretch_sampler(lnprob_ref, pos0, NSTEPS, seed=SEED_CHAIN)
    dt = time.perf_counter() - t0

    flat = chain[BURN:].reshape(-1, 4)
    # per-parameter MC-error ingredients (walkers-as-chains ESS)
    from cha1_mcmc_tpu.sampler.diagnostics import autocorr_time
    wsd = chain[BURN:].transpose(1, 0, 2)  # (W, S, D)
    tau = autocorr_time(wsd)
    ess = wsd.shape[0] * wsd.shape[1] / tau
    kurt = np.mean(((flat - flat.mean(0)) / flat.std(0)) ** 4, axis=0)
    out = {
        "provenance": {
            "generator": "tools/make_reference_posterior.py",
            "lnprob": "reference SpectralFitMCMC.lnprob executed in place "
                      "(reference inference.py:127-246)",
            "data": "reference data/DSN/cha_mms1_hc5n_example.npy (shipped)",
            "sampler": "NumPy emcee-v3 stretch move "
                       "(tests/test_convergence.py:_numpy_stretch_sampler)",
            "nwalkers": NWALKERS, "nsteps": NSTEPS, "burn": BURN,
            "seed_init": SEED_INIT, "seed_chain": SEED_CHAIN,
            "wall_seconds": round(dt, 1),
        },
        "params": PARAMS,
        "mean": {p: float(flat[:, i].mean()) for i, p in enumerate(PARAMS)},
        "std": {p: float(flat[:, i].std()) for i, p in enumerate(PARAMS)},
        "p16": {p: float(np.percentile(flat[:, i], 16)) for i, p in enumerate(PARAMS)},
        "p50": {p: float(np.percentile(flat[:, i], 50)) for i, p in enumerate(PARAMS)},
        "p84": {p: float(np.percentile(flat[:, i], 84)) for i, p in enumerate(PARAMS)},
        "ess": {p: float(ess[i]) for i, p in enumerate(PARAMS)},
        "tau": {p: float(tau[i]) for i, p in enumerate(PARAMS)},
        "kurtosis": {p: float(kurt[i]) for i, p in enumerate(PARAMS)},
    }
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tests", "golden", "hc5n_reference_posterior.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)
    print(f"wrote {path} ({dt:.0f}s)")
    for p in PARAMS:
        print(f"  {p}: mean {out['mean'][p]:.6e}  std {out['std'][p]:.6e}")


if __name__ == "__main__":
    main()
