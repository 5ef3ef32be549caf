"""Independent grid-chi^2 cross-validation.

The reference validates its MCMC pipeline against CASSIS's independent
chi^2/MCMC engine over parameter grids (reference
scripts/CASSIS/Cha1_HC5N_CASSIS.py:62-144: nmol/temp/vlsr/size ranges with
a fixed fwhm). CASSIS itself is an external Java application; this module
plays the same methodological role natively: a brute-force chi^2 scan of
the *same* forward model over a parameter grid, giving an MCMC-independent
check that the posterior mode sits at the grid minimum.

On the accelerator the whole grid is one vmapped batch — a million grid points is a
single device call.
"""

from __future__ import annotations

import itertools

import numpy as np
import jax
import jax.numpy as jnp

from cha1_mcmc_tpu.models.forward import SpectralModel
from cha1_mcmc_tpu.inference.params import ParamSpec
from cha1_mcmc_tpu.inference.likelihood import build_lnlike

__all__ = ["grid_chi2"]


def grid_chi2(model: SpectralModel, spec: ParamSpec, grid_ints, grid_yerrs,
              param_grids: dict, *, batch: int = 65536):
    """Evaluate -2 lnlike on the outer product of per-parameter grids.

    param_grids maps parameter names (in theta order, e.g. 'Ncol', 'Tex',
    'vlsr', 'dV' for the fixed-source-size layout) to 1D arrays. Returns
    (thetas (G, D), chi2 (G,), best_theta). Mirrors the CASSIS
    min/max/steps vocabulary (reference Cha1_HC5N_CASSIS.py:66-101).
    """
    axes = [np.asarray(v, dtype=np.float64) for v in param_grids.values()]
    thetas = np.array(list(itertools.product(*axes)), dtype=np.float64)
    lnlike = build_lnlike(model, spec, grid_ints, grid_yerrs)
    batched = jax.jit(jax.vmap(lnlike))
    out = []
    for s in range(0, len(thetas), batch):
        out.append(np.asarray(batched(jnp.asarray(thetas[s:s + batch], model.dtype))))
    lnl = np.concatenate(out)
    chi2 = -2.0 * lnl
    return thetas, chi2, thetas[int(np.argmin(chi2))]
