"""Affine-invariant ensemble MCMC on device."""

from cha1_mcmc_tpu.sampler.stretch import (EnsembleSampler, MultiChainSampler,
                                            run_ensemble, run_ensemble_chains)
from cha1_mcmc_tpu.sampler.chain import (
    save_chain,
    load_chain,
    last_position,
    chain_to_priors,
    initialize_walkers,
)
from cha1_mcmc_tpu.sampler.diagnostics import (
    autocorr_time,
    effective_sample_size,
    gelman_rubin,
    summarize_convergence,
)

__all__ = [
    "EnsembleSampler",
    "MultiChainSampler",
    "run_ensemble",
    "run_ensemble_chains",
    "save_chain",
    "load_chain",
    "last_position",
    "chain_to_priors",
    "initialize_walkers",
    "autocorr_time",
    "effective_sample_size",
    "gelman_rubin",
    "summarize_convergence",
]
