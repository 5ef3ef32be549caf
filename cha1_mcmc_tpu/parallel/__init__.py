"""Multi-device execution over a jax.sharding.Mesh.

The reference's entire distributed story is a CPython multiprocessing pool
mapping walker lnprob evaluations onto CPU processes (reference
inference.py:456-463). Here it is a ('chains', 'walkers', 'lines') device
mesh:

  * 'chains' axis — independent ensembles (no collective crosses it), for
    an honest cross-chain R-hat.
  * 'walkers' axis — ensemble data parallelism. Each device owns a walker
    shard; the stretch move's complementary half is `all_gather`ed once per
    half-step (a few KB).
  * 'lines' axis — model parallelism over catalog transitions for dense
    catalogs (35k+ lines): each device accumulates Gaussian opacity over its
    line shard and the partials are `psum`ed.

Multi-host is reserved for independent chains/molecules (multihost.py).
"""

from cha1_mcmc_tpu.parallel.sharded import (
    ShardedEnsembleSampler,
    make_mesh,
    make_sharded_lnprob,
    make_sharded_runner,
    make_sharded_sampler,
    pad_model_lines,
    run_ensemble_sharded,
)

__all__ = ["ShardedEnsembleSampler", "make_mesh", "make_sharded_lnprob",
           "make_sharded_runner",
           "make_sharded_sampler", "pad_model_lines", "run_ensemble_sharded"]
