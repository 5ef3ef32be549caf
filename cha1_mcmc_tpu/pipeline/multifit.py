"""Multi-component (GOTHAM / TMC-1 style) fit driver.

Device-side equivalent of the reference's 4-component TMC-1 pipeline
(reference scripts/MCMC/TMC1_four_component.py): N velocity components with
per-component source size / column density / vlsr and shared Tex / dV,
ordered-velocity priors, GOTHAM-variant data reduction, and the
median-of-last-200-steps restart convention.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp

from cha1_mcmc_tpu.constants import CYAN, GRAY, RESET
from cha1_mcmc_tpu.catalogs import load_catalog
from cha1_mcmc_tpu.models.forward import SpectralModel, simulate_sticks_host
from cha1_mcmc_tpu.inference import ParamSpec, ordered_velocity_lnprior, build_lnprob
from cha1_mcmc_tpu.sampler import EnsembleSampler, chain_to_priors, load_chain
from cha1_mcmc_tpu.reduce.datagrid import Datagrid, read_spectrum_gotham, save_datagrid
from cha1_mcmc_tpu.pipeline.plotting import plot_results

__all__ = ["MultiFitConfig", "MultiComponentFit"]

# Reference hardcoded HC9N template priors (TMC1_four_component.py:292-294).
_HC9N_MEANS = (37.0, 25.0, 56.0, 22.0, 2.47e12, 11.19e12, 2.20e12, 5.64e12,
               6.7, 5.624, 5.790, 5.910, 6.033, 0.117)
_HC9N_STDS = (2.5, 2.0, 6.5, 2.0, 0.30e12, 1.75e12, 0.265e12, 1.185e12,
              0.1, 0.0015, 0.001, 0.0035, 0.002, 0.002)
# Walker-ball perturbation (TMC1_four_component.py:330).
_PERTURBATION = (1e-1, 1e-1, 1e-1, 1e-1, 1e10, 1e10, 1e10, 1e10,
                 1e-3, 1e-3, 1e-3, 1e-3, 1e-3, 1e-3)


@dataclasses.dataclass
class MultiFitConfig:
    """Mirrors the TMC-1 script's input_dict
    (reference TMC1_four_component.py:393-403) plus model geometry."""

    mol_name: str
    fit_folder: str = "GOTHAM_fit_results"
    cat_folder: str = "catalog"
    data_path: str | None = None
    block_interlopers: bool = True
    nruns: int = 10_000
    nwalkers: int = 128
    template_run: bool = False
    restart: bool = True
    prior_path: str | None = None

    ncomp: int = 4
    # Observation geometry (reference TMC1_four_component.py:122,160,173,367)
    dish_size: float = 100.0
    lower_limit: float = 7000.0
    upper_limit: float = 30000.0
    source_velocity: float = 5.8       # mask center (reference :160)
    # Fiducial sim for covered-line selection (reference :367)
    fiducial: tuple = (7.0e11, 0.37, 8.0, 40.0)  # (C, dV, T, source_size)

    template_means: tuple = _HC9N_MEANS
    template_stds: tuple = _HC9N_STDS
    initial: tuple | None = None       # overrides template means as start
    perturbation: tuple = _PERTURBATION

    seed: int = 0
    checkpoint_every: int = 512
    dtype: str = "float32"
    stretch_a: float = 2.0
    use_sparse_opacity: bool = True  # channel-major gather opacity (set
                                     # False for the dense einsum path).
                                     # Single-device only: the sharded
                                     # (n_devices > 1) runner keeps its
                                     # einsum formulation.
    dv_bound: float = 0.3            # hard upper bound on dV, shared by the
                                     # prior box (ordered_velocity_lnprior)
                                     # and the gather table's static window
                                     # (reference TMC1_four_component.py:224)
    n_devices: int | None = None     # shard the fit over this many devices
    n_line_shards: int = 1           # of which, this many shard the line axis
    n_chains: int = 1                # independent ensembles (nwalkers is the
                                     # total; enables cross-chain R-hat)

    @property
    def ndim(self) -> int:
        return 3 * self.ncomp + 2

    @property
    def catfile_path(self) -> str:
        return os.path.join(self.cat_folder, f"{self.mol_name}.cat")

    @property
    def mol_folder(self) -> str:
        return os.path.join(self.fit_folder, self.mol_name)

    @property
    def chain_path(self) -> str:
        return os.path.join(self.mol_folder, "chain.npy")

    @property
    def datagrid_path(self) -> str:
        return os.path.join(
            self.mol_folder, f"all_{self.mol_name}_lines_GOTHAM_freq_space.npy")


class MultiComponentFit:
    """End-to-end N-component GOTHAM fit."""

    def __init__(self, config: MultiFitConfig):
        from cha1_mcmc_tpu.utils import enable_compilation_cache

        enable_compilation_cache()  # reruns skip recompilation
        self.config = config
        self.spec = ParamSpec(ncomp=config.ncomp)
        self.dtype = jnp.dtype(config.dtype)
        self.catalog = None
        self.sampler: EnsembleSampler | None = None

    def init_setup(self) -> Datagrid:
        """Reduce the GOTHAM spectrum once
        (reference TMC1_four_component.py:353-383)."""
        cfg = self.config
        print(f"{CYAN}Running setup for: {cfg.mol_name}, "
              f"block interlopers = {cfg.block_interlopers}.{RESET}")
        if not os.path.exists(cfg.catfile_path):
            raise FileNotFoundError(f"No catalog file found at {cfg.catfile_path}.")
        os.makedirs(cfg.mol_folder, exist_ok=True)
        self.catalog = load_catalog(cfg.catfile_path, name=cfg.mol_name)
        C, dV, T, ss = cfg.fiducial
        freq_sim, int_sim, _ = simulate_sticks_host(
            self.catalog, C=[C], dV=[dV], T=[T],
            ll=[cfg.lower_limit], ul=[cfg.upper_limit],
            source_size=ss, dish_size=cfg.dish_size)
        data = np.load(cfg.data_path, allow_pickle=True)
        grid = read_spectrum_gotham(
            data, freq_sim, int_sim, block_interlopers=cfg.block_interlopers)
        save_datagrid(cfg.datagrid_path, grid)
        print(f"{GRAY}Saved reduced spectrum to: {cfg.datagrid_path}{RESET}")
        return grid

    def build_model(self, grid: Datagrid) -> SpectralModel:
        cfg = self.config
        if self.catalog is None:
            self.catalog = load_catalog(cfg.catfile_path, name=cfg.mol_name)
        return SpectralModel.build(
            self.catalog, grid.covered_trans, grid.freqs,
            ll=cfg.lower_limit, ul=cfg.upper_limit,
            dish_size=cfg.dish_size,
            vel_offset=0.0, mask_center=cfg.source_velocity,
            dtype=self.dtype)

    def _attach_device_q(self, model: SpectralModel,
                         prior_means, prior_stds) -> SpectralModel:
        """Device Chebyshev surrogate for state-sum Q (same rationale as
        the single-component pipeline, SpectralFit.build_model: the
        16k-state Boltzmann walk is a (walkers x states) exp per
        evaluation; host/f64 oracles keep the exact sum).
        Unlike the single-component prior, the multifit Tex prior has no
        hard upper box (reference TMC1_four_component.py bounds Tex
        below only), so the fit interval is sized from the ACTUAL
        Gaussian prior — out to 16 sigma, and at least 60 K (the
        reference's own hottest Q-validity warning,
        functions.py:256-261). A walker beyond the interval carries a
        >= -128 lnprior penalty, is practically unreachable from the
        near-mean init ball, and fit_device_cheb falls back to the
        exact in-kernel state walk whenever the wider interval cannot
        be fit to tolerance."""
        if model.q_model.kind != "states":
            return model
        from cha1_mcmc_tpu.catalogs.partition import fit_device_cheb

        n = self.config.ncomp
        mean_tex = float(np.asarray(prior_means)[2 * n])
        std_tex = float(np.asarray(prior_stds)[2 * n])
        t_hi = max(60.0, mean_tex + 16.0 * std_tex)
        return dataclasses.replace(
            model, q_model=fit_device_cheb(model.q_model, 2.7, t_hi))

    def fit(self, grid: Datagrid) -> np.ndarray:
        """Sample the N-component posterior
        (reference fit_multi_gaussian, TMC1_four_component.py:280-350)."""
        cfg = self.config
        print(f"{CYAN}Fitting column densities for {cfg.mol_name}. "
              f"Restart = {cfg.restart}.{RESET}")
        model = self.build_model(grid)

        if cfg.template_run:
            initial = np.asarray(cfg.template_means, dtype=np.float64)
            prior_means, prior_stds = initial, np.asarray(cfg.template_stds)
        else:
            prior_chain = load_chain(cfg.prior_path)
            prior_means, prior_stds = chain_to_priors(prior_chain)
            if prior_means.shape != (cfg.ndim,):
                raise ValueError(
                    f"prior chain has ndim {prior_means.shape}, expected {cfg.ndim}")
            if cfg.restart:
                initial = np.asarray(cfg.initial if cfg.initial is not None
                                     else cfg.template_means, dtype=np.float64)
            else:
                # Continue from the median of the last 200 steps
                # (reference TMC1_four_component.py:325-327).
                chain_data = load_chain(cfg.chain_path)[:, -200:, :].reshape(-1, cfg.ndim).T
                initial = np.median(chain_data, axis=1)

        model = self._attach_device_q(model, prior_means, prior_stds)
        lnprior = ordered_velocity_lnprior(self.spec, prior_means, prior_stds,
                                           dv_max=cfg.dv_bound)

        # Fixed-perturbation walker ball, no rejection
        # (reference TMC1_four_component.py:330-331).
        rng = np.random.default_rng(cfg.seed)
        perturbation = np.asarray(cfg.perturbation, dtype=np.float64)
        pos = initial + perturbation * rng.standard_normal((cfg.nwalkers, cfg.ndim))

        if cfg.n_devices is not None and cfg.n_devices > 1:
            # The sharded runner is ncomp-generic (spec.unpack + the
            # component axis of forward_from_lines), so the widest model
            # (reference TMC1_four_component.py, 14-dim) shards the same
            # way as the single-component fit: walkers (dp) x lines (tp).
            from cha1_mcmc_tpu.parallel import make_sharded_sampler

            self.sampler = make_sharded_sampler(
                n_devices=cfg.n_devices, n_line_shards=cfg.n_line_shards,
                nwalkers=cfg.nwalkers, ndim=cfg.ndim, a=cfg.stretch_a,
                dtype=self.dtype, model=model, spec=self.spec,
                grid_ints=grid.ints, grid_yerrs=grid.yerrs,
                lnprior_fn=lnprior, n_chains=cfg.n_chains)
        elif cfg.n_chains > 1:
            # K independent ensembles (cross-chain R-hat).
            from cha1_mcmc_tpu.inference import build_lnprob_batched
            from cha1_mcmc_tpu.sampler import MultiChainSampler

            lnprob_b = build_lnprob_batched(
                model, self.spec, grid.ints, grid.yerrs, lnprior,
                use_pallas=True, dv_max=cfg.dv_bound)
            self.sampler = MultiChainSampler(
                lnprob_fn=lnprob_b, nwalkers=cfg.nwalkers, ndim=cfg.ndim,
                a=cfg.stretch_a, dtype=self.dtype, batched=True,
                n_chains=cfg.n_chains)
        elif cfg.use_sparse_opacity:
            # Channel-major gather opacity: the GOTHAM datagrids are
            # ~1.5% window-dense (each covered line touches ~17 of the
            # 1133 channels at the 0.3 km/s dV prior bound). cfg.dv_bound
            # feeds BOTH the prior's hard dV bound and the static table's
            # window, so the table is exact for every in-bounds walker;
            # lnprob agrees with the dense path to f32 round-off
            # (out-of-bounds proposals are -inf either way).
            from cha1_mcmc_tpu.inference import build_lnprob_batched

            lnprob_b = build_lnprob_batched(
                model, self.spec, grid.ints, grid.yerrs, lnprior,
                use_pallas=True, dv_max=cfg.dv_bound)
            self.sampler = EnsembleSampler(
                lnprob_fn=lnprob_b, nwalkers=cfg.nwalkers, ndim=cfg.ndim,
                a=cfg.stretch_a, dtype=self.dtype, batched=True)
        else:
            lnprob = build_lnprob(model, self.spec, grid.ints, grid.yerrs,
                                  lnprior)
            self.sampler = EnsembleSampler(
                lnprob_fn=lnprob, nwalkers=cfg.nwalkers, ndim=cfg.ndim,
                a=cfg.stretch_a, dtype=self.dtype)
        key = jax.random.PRNGKey(cfg.seed)

        from cha1_mcmc_tpu.utils import Throughput

        throughput = Throughput()
        with throughput:
            self.sampler.run_mcmc(
                pos, cfg.nruns, key, checkpoint_every=cfg.checkpoint_every,
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

    def run(self) -> np.ndarray:
        grid = self.init_setup()
        chain = self.fit(grid)
        plot_results(self.config.chain_path, self.spec.labels, self.spec.labels_latex)
        return chain
