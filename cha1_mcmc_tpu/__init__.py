"""cha1_mcmc_tpu — LTE spectral-line MCMC framework on JAX accelerators.

A from-scratch JAX/XLA rebuild of the capabilities of the
KahaanGandhi/Cha1-MCMC reference (LTE molecular-emission fitting of sparse
radio spectra with an affine-invariant ensemble MCMC, per Loomis et al.,
Nat Astron 5, 188-196, 2021).

Design stance (accelerator-first, not a port):
  * The catalog is parsed once on the host into frozen static arrays.
  * The entire likelihood - partition function, opacity sticks, Gaussian
    opacity accumulation, radiative transfer, beam dilution, chi^2 - is one
    jitted, statically-shaped jnp program (reference recomputes it per call
    in object-oriented NumPy, see reference inference.py:127-166).
  * Walkers are a `vmap` axis on one device; across devices they are a
    sharded mesh axis (the reference ships walkers to CPU processes over
    pickled pipes, reference inference.py:456-463).
  * Dense catalogs (35k+ transitions) evaluate the opacity through a
    channel-major gather over the +-10*dV velocity window, and can shard
    the *line* axis with a `psum` over partial opacity accumulations.
"""

__version__ = "0.1.0"

from cha1_mcmc_tpu import constants
from cha1_mcmc_tpu.catalogs import Catalog, load_catalog, QModel
from cha1_mcmc_tpu.models import SpectralModel
from cha1_mcmc_tpu.sampler import EnsembleSampler, run_ensemble
from cha1_mcmc_tpu.pipeline import FitConfig, SpectralFit, MultiFitConfig, MultiComponentFit

__all__ = [
    "constants",
    "Catalog",
    "load_catalog",
    "QModel",
    "SpectralModel",
    "EnsembleSampler",
    "run_ensemble",
    "FitConfig",
    "SpectralFit",
    "MultiFitConfig",
    "MultiComponentFit",
    "__version__",
]
