"""Fit driver: the device-side equivalent of the reference's
SpectralFitMCMC orchestration (reference inference.py:63-488).

Flow (reference run(), inference.py:475-488):
  init_setup (reduce data once) -> choose priors (template or
  posterior-as-prior from a previous chain) -> optional MLE Ncol init ->
  rejection-init the walker ball -> sample with per-block checkpoints ->
  posterior plots + summary table.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp

from cha1_mcmc_tpu.constants import CYAN, GRAY, GREEN, RED, RESET
from cha1_mcmc_tpu.catalogs import load_catalog
from cha1_mcmc_tpu.catalogs.partition import fit_device_cheb
from cha1_mcmc_tpu.models.forward import SpectralModel
from cha1_mcmc_tpu.inference import (
    ParamSpec,
    single_component_lnprior,
    build_lnlike,
    build_lnprob,
    estimate_ncol_mle,
)
from cha1_mcmc_tpu.sampler import (
    EnsembleSampler,
    chain_to_priors,
    initialize_walkers,
    load_chain,
)
from cha1_mcmc_tpu.reduce.datagrid import (
    Datagrid,
    reduce_spectrum,
    save_datagrid,
)
from cha1_mcmc_tpu.pipeline.config import FitConfig
from cha1_mcmc_tpu.pipeline.plotting import plot_results

__all__ = ["SpectralFit", "dense_catalog"]


def dense_catalog(model: SpectralModel) -> bool:
    """The automatic opacity choice (FitConfig.use_pallas=None): the sparse
    gather for dense catalogs. The vmapped einsum materializes a
    (W/2, L, C) intermediate per half-step, which for aromatic catalogs
    (35,460-line 1-cyanonaphthalene x 2048 channels x 64 walkers = ~19 GB
    f32) cannot compile, while the gather touches only the in-window
    (line, channel) pairs."""
    return model.n_lines * model.n_channels > 4_000_000


class SpectralFit:
    """End-to-end single-molecule fit on the default JAX device."""

    def __init__(self, config: FitConfig):
        from cha1_mcmc_tpu.utils import enable_compilation_cache

        enable_compilation_cache()  # reruns skip recompilation
        self.config = config
        self.spec = ParamSpec(ncomp=1, fixed_source_size=config.fixed_source_size)
        self.dtype = jnp.dtype(config.dtype)
        self.catalog = None
        self.sampler: EnsembleSampler | None = None

    def _precision_scope(self):
        """Scoped full-precision verification mode: dtype="float64" runs
        inside the enable_x64 context instead of flipping the
        process-global jax_enable_x64 flag for the rest of the
        interpreter."""
        if self.config.dtype == "float64" and not jax.config.jax_enable_x64:
            return jax.enable_x64()
        import contextlib

        return contextlib.nullcontext()

    # -- data reduction ----------------------------------------------------
    def init_setup(self) -> Datagrid:
        """Reduce the observed spectrum once (reference inference.py:305-342)."""
        cfg = self.config
        print(f"\n{CYAN}Reducing spectral data for {cfg.mol_name}.{RESET}")
        if not os.path.exists(cfg.catfile_path):
            raise FileNotFoundError(f"No catalog file found at {cfg.catfile_path}.")
        os.makedirs(cfg.mol_folder, exist_ok=True)
        self.catalog = load_catalog(cfg.catfile_path, name=cfg.mol_name)
        source_size = (cfg.fixed_source_size if cfg.fixed_source_size is not None
                       else cfg.template_means[0])
        grid = reduce_spectrum(
            self.catalog, cfg.data_path,
            ll=cfg.lower_limit, ul=cfg.upper_limit,
            aligned_velocity=cfg.aligned_velocity,
            dish_size=cfg.dish_size, source_size=source_size,
            block_interlopers=cfg.block_interlopers,
        )
        save_datagrid(cfg.datagrid_path, grid)
        print(f"{GRAY}Saved reduced spectrum to: {cfg.datagrid_path}{RESET}\n")
        return grid

    # -- model assembly ----------------------------------------------------
    def build_model(self, grid: Datagrid) -> SpectralModel:
        cfg = self.config
        if self.catalog is None:
            self.catalog = load_catalog(cfg.catfile_path, name=cfg.mol_name)
        model = SpectralModel.build(
            self.catalog, grid.covered_trans, grid.freqs,
            ll=cfg.lower_limit, ul=cfg.upper_limit,
            dish_size=cfg.dish_size,
            vel_offset=cfg.aligned_velocity,
            mask_center=cfg.aligned_velocity,
            dtype=self.dtype,
        )
        if model.q_model.kind == "states":
            # Device Chebyshev surrogate over the sampler's Tex prior
            # box (partition.py:fit_device_cheb): the aromatics'
            # 16k-state Boltzmann walk is a (walkers x states) exp per
            # evaluation; a ulp-equivalent degree-~16 fit replaces it
            # on-device, while
            # every host/f64 oracle path keeps the exact reference
            # state sum. Out-of-box Tex is -inf by the prior before
            # Q's value matters.
            t_lo, t_hi = cfg.bounds["Tex"]
            model = dataclasses.replace(
                model, q_model=fit_device_cheb(model.q_model, t_lo, t_hi))
        return model

    def _is_within_bounds(self, theta) -> bool:
        """Host-side box check for walker init (reference inference.py:169-190)."""
        b = self.config.bounds
        keys = (["Ncol", "Tex", "vlsr", "dV"] if self.spec.fixed_source_size is not None
                else ["source_size", "Ncol", "Tex", "vlsr", "dV"])
        return all(b[k][0] < v < b[k][1] for k, v in zip(keys, theta))

    # -- fitting -----------------------------------------------------------
    def fit(self, grid: Datagrid) -> np.ndarray:
        """Sample the posterior; returns the (W, S, D) chain
        (reference fit_multi_gaussian, inference.py:379-473)."""
        with self._precision_scope():
            return self._fit(grid)

    def _fit(self, grid: Datagrid) -> np.ndarray:
        cfg = self.config
        print(f"{CYAN}Estimating free parameters for {cfg.mol_name}.{RESET}")
        model = self.build_model(grid)

        if cfg.template_run:
            initial = np.asarray(cfg.template_means, dtype=np.float64)
            prior_means, prior_stds = initial, np.asarray(cfg.template_stds)
            print(f"{GRAY}Using template priors and initial positions for {cfg.mol_name}.{RESET}")
        else:
            prior_chain = load_chain(cfg.prior_path)
            prior_means, prior_stds = chain_to_priors(prior_chain)
            initial = prior_means.copy()
            print(f"{GRAY}Loaded priors from previous chain: {cfg.prior_path}{RESET}")

        lnprior = single_component_lnprior(self.spec, cfg.bounds, prior_means, prior_stds)
        lnlike = build_lnlike(model, self.spec, grid.ints, grid.yerrs)
        use_pallas = cfg.use_pallas
        if use_pallas is None:
            use_pallas = dense_catalog(model)
            if use_pallas:
                print(f"{GRAY}Dense catalog ({model.n_lines} lines x "
                      f"{model.n_channels} channels): auto-selected the "
                      f"sparse opacity path.{RESET}")
        sharded = cfg.n_devices is not None and cfg.n_devices > 1
        if sharded:
            lnprob = None  # the mesh program builds its own local lnprob
        elif use_pallas:
            from cha1_mcmc_tpu.inference.likelihood import build_lnprob_batched

            lnprob = build_lnprob_batched(
                model, self.spec, grid.ints, grid.yerrs, lnprior,
                use_pallas=True, dv_max=cfg.bounds["dV"][1])
        else:
            lnprob = build_lnprob(model, self.spec, grid.ints, grid.yerrs, lnprior)

        resuming = cfg.resume and os.path.exists(cfg.chain_path)
        if cfg.MLE_for_Ncol and not resuming:  # resume discards `initial`
            print(f"{GRAY}Initializing Ncol via MLE.{RESET}")
            if use_pallas:
                # The scalar lnlike closes over the (L, C) velocity grid —
                # a ~290 MB constant on dense catalogs; the gather-table
                # batched lnlike carries only the active-line tables
                # (inference/likelihood.py).
                from cha1_mcmc_tpu.inference.likelihood import (
                    build_lnlike_batched)

                lnlike_mle, mle_batched = build_lnlike_batched(
                    model, self.spec, grid.ints, grid.yerrs,
                    use_pallas=True, dv_max=cfg.bounds["dV"][1]), True
            else:
                lnlike_mle, mle_batched = lnlike, False
            try:
                est = estimate_ncol_mle(lnlike_mle, self.spec, initial,
                                        cfg.bounds["Ncol"],
                                        batched=mle_batched)
                ncol_index = 0 if cfg.fixed_source_size is not None else 1
                initial = np.array(initial, dtype=np.float64)
                initial[ncol_index] = est
                print(f"{GREEN}Successful MLE fit for column density. "
                      f"Prior Ncol: {est:.3e}{RESET}")
            except RuntimeError as e:
                print(f"{RED}Failed to initialize Ncol via MLE: {e}{RESET}")
                raise

        if sharded:
            # Multi-device sampling: shard walkers (and optionally catalog
            # lines) over a device mesh, with the full single-device
            # sampler contract (checkpoints, .state.npz resume, retries).
            # Replaces the reference's multiprocessing pool
            # (inference.py:456-463). n_chains > 1 composes K independent
            # ensembles with the mesh (a 'chains' axis) for cross-chain
            # R-hat.
            from cha1_mcmc_tpu.parallel import make_sharded_sampler

            self.sampler = make_sharded_sampler(
                n_devices=cfg.n_devices, n_line_shards=cfg.n_line_shards,
                nwalkers=cfg.nwalkers, ndim=self.spec.ndim, a=cfg.stretch_a,
                dtype=self.dtype, model=model, spec=self.spec,
                grid_ints=grid.ints, grid_yerrs=grid.yerrs,
                lnprior_fn=lnprior, use_pallas=use_pallas,
                dv_max=cfg.bounds["dV"][1], n_chains=cfg.n_chains)
        elif cfg.n_chains > 1:
            from cha1_mcmc_tpu.sampler import MultiChainSampler

            self.sampler = MultiChainSampler(
                lnprob_fn=lnprob, nwalkers=cfg.nwalkers, ndim=self.spec.ndim,
                a=cfg.stretch_a, dtype=self.dtype, batched=use_pallas,
                n_chains=cfg.n_chains)
        else:
            self.sampler = EnsembleSampler(
                lnprob_fn=lnprob, nwalkers=cfg.nwalkers, ndim=self.spec.ndim,
                a=cfg.stretch_a, dtype=self.dtype, batched=use_pallas)

        if resuming:
            # Continue an existing chain from its last positions
            # (reference inference.py:463 / TMC1 restart=False convention).
            prev = np.load(cfg.chain_path)
            pos = self.sampler.preload(prev)
            print(f"{GRAY}Resuming from {cfg.chain_path} "
                  f"({prev.shape[1]} existing steps).{RESET}")
            state = self.sampler.load_state(cfg.chain_path)
            if state is not None:
                pos, lnp0, key = state  # exact random-stream continuation
            else:
                lnp0 = None
                key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), prev.shape[1])
        else:
            rng = np.random.default_rng(cfg.seed)
            pos = initialize_walkers(initial, prior_stds, cfg.nwalkers,
                                     self._is_within_bounds, rng=rng)
            key = jax.random.PRNGKey(cfg.seed)
            lnp0 = None

        from cha1_mcmc_tpu.utils import Throughput, trace_profile

        throughput = Throughput()
        with trace_profile(cfg.profile_dir), throughput:
            self.sampler.run_mcmc(
                pos, cfg.nruns, key, lnp0=lnp0,
                checkpoint_every=cfg.checkpoint_every,
                chain_file=cfg.chain_path, progress=True)
        throughput.add(cfg.nruns, cfg.nwalkers)
        throughput.save(os.path.join(cfg.mol_folder, "throughput.json"))
        print(f"{GRAY}Acceptance fraction: "
              f"{self.sampler.acceptance_fraction:.3f}  |  "
              f"{throughput.walker_steps_per_sec:,.0f} walker-steps/s "
              f"(wall, incl. compile + checkpoints){RESET}")
        if cfg.n_chains > 1:
            from cha1_mcmc_tpu.sampler import summarize_convergence

            conv = summarize_convergence(self.sampler.chain)
            rhat = ", ".join(f"{lbl}={r:.3f}" for lbl, r in
                             zip(self.spec.labels, conv["r_hat"]))
            print(f"{GRAY}Cross-chain R-hat ({cfg.n_chains} chains): {rhat}{RESET}")
        return self.sampler.chain

    # -- full run ----------------------------------------------------------
    def run(self) -> np.ndarray:
        cfg = self.config
        grid = self.init_setup()
        chain = self.fit(grid)
        cfg.to_json(os.path.join(cfg.mol_folder, "config.json"))
        plot_results(cfg.chain_path, self.spec.labels, self.spec.labels_latex)
        return chain
