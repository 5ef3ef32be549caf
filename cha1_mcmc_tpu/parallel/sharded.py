"""shard_map ensemble sampling over a ('chains', 'walkers', 'lines') mesh.

Collective pattern per ensemble step:
  all_gather(complement half)   — 2x per step, (W/2, D) each (D <= 14)
  psum(partial opacity)         — inside each lnprob eval, only if the
                                  lines axis has > 1 shard

Split semantics: emcee's RedBlueMove shuffles the *global* walker index
vector each step (randomize_split). A global shuffle does not shard — a
device's two half-populations would be unequal and data-dependent. The
sharded move instead draws an independent random permutation of each
device's local walkers per step (so every device contributes exactly
W_local/2 walkers to each half), and each active walker pairs with a
uniform draw from the *globally gathered* complementary half. This is a
valid Goodman–Weare partition scheme (halves are random, updates are
sequential, partners span the full complement) that differs from emcee
only in constraining the split to be balanced per shard; a distributional
test against the single-device sampler gates the equivalence
(tests/test_parallel.py).

Randomness: every device folds the step key with its walker-shard index
only, so the devices of one walker shard (across the lines axis) see
identical randomness and stay in lockstep, while different walker shards
draw independently.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from cha1_mcmc_tpu.models.forward import SpectralModel, forward_from_lines
from cha1_mcmc_tpu.inference.params import ParamSpec
from cha1_mcmc_tpu.sampler.stretch import EnsembleSampler

__all__ = ["make_mesh", "pad_model_lines", "run_ensemble_sharded",
           "make_sharded_lnprob", "make_sharded_runner",
           "make_sharded_sampler", "ShardedEnsembleSampler"]

CHAIN_AXIS = "chains"
WALKER_AXIS = "walkers"
LINE_AXIS = "lines"


def make_mesh(n_walker_shards: int | None = None, n_line_shards: int = 1,
              devices=None, n_chain_shards: int = 1) -> Mesh:
    """Build a ('chains', 'walkers', 'lines') mesh over the available
    devices. The chains axis carries K *independent* ensembles (no
    collectives cross it — all_gather/psum ride the walkers/lines axes
    only), composing walker sharding with honest cross-chain
    R-hat; size 1 recovers the plain ('walkers', 'lines') layout."""
    devices = list(devices if devices is not None else jax.devices())
    if n_walker_shards is None:
        n_walker_shards = len(devices) // (n_line_shards * n_chain_shards)
    n = n_chain_shards * n_walker_shards * n_line_shards
    grid = np.array(devices[:n]).reshape(
        n_chain_shards, n_walker_shards, n_line_shards)
    return Mesh(grid, (CHAIN_AXIS, WALKER_AXIS, LINE_AXIS))


def pad_model_lines(model: SpectralModel, multiple: int) -> SpectralModel:
    """Pad the line axis to a multiple so it splits evenly across shards.

    Padding lines carry aij = 0, hence tau = 0: they contribute nothing to
    the accumulated opacity.
    """
    L = model.n_lines
    target = -(-L // multiple) * multiple
    if target == L:
        return model
    pad = target - L

    def pad1(x, value=0.0):
        return jnp.concatenate([x, jnp.full((pad,) + x.shape[1:], value, x.dtype)])

    return dataclasses.replace(
        model,
        line_freq=pad1(model.line_freq, 1.0),   # nonzero: avoids 0-division
        line_elower=pad1(model.line_elower),
        line_aij=pad1(model.line_aij, 0.0),     # zero Einstein A => tau = 0
        line_gup=pad1(model.line_gup, 1.0),
        line_glow=pad1(model.line_glow, 1.0),
        vel_grid=jnp.concatenate(
            [model.vel_grid,
             jnp.broadcast_to(model.vel_grid[-1:], (pad, model.n_channels))]),
    )


def _half_step_sharded(lnprob_batch, ndim, a, coords, lnp, active_idx, comp_idx,
                       z_u, pair, acc_u):
    """Update the local walkers `active_idx` using the globally gathered
    complement `comp_idx`, with pre-generated uniforms (see
    sampler/stretch.py for the bulk-RNG rationale)."""
    s = coords[active_idx]
    comp = jax.lax.all_gather(coords[comp_idx], WALKER_AXIS, axis=0, tiled=True)

    z = ((a - 1.0) * z_u + 1.0) ** 2 / a
    c = comp[pair]
    proposal = c + z[:, None] * (s - c)

    lnp_new = lnprob_batch(proposal)
    lnpdiff = (ndim - 1.0) * jnp.log(z) + lnp_new - lnp[active_idx]
    accept = jnp.log(acc_u) < lnpdiff

    coords = coords.at[active_idx].set(jnp.where(accept[:, None], proposal, s))
    lnp = lnp.at[active_idx].set(jnp.where(accept, lnp_new, lnp[active_idx]))
    return coords, lnp, jnp.sum(accept)


def _local_lnprob(model: SpectralModel, spec: ParamSpec, grid_ints,
                  grid_yerrs, lnprior_fn, mesh: Mesh, use_pallas: bool,
                  dv_max: float | None):
    """Per-device walker-batched lnprob over a line shard.

    Returns (line_args, line_specs, local_lnprob_batch): the global line
    arrays to pass into shard_map, their 'lines'-axis partition specs, and
    `local_lnprob_batch(lines_local, thetas (N, D)) -> (N,)`, which must run
    inside shard_map over `mesh`. use_pallas=True evaluates each shard
    through the sparse channel-major gather (models/opacity.py: per-shard
    tables padded to a common size and sharded on the 'lines' axis);
    otherwise each shard runs the dense einsum. Either way the (N, C)
    partial opacity is psum'ed over the lines axis once per evaluation.
    """
    n_l = mesh.shape[LINE_AXIS]
    model = pad_model_lines(model, n_l)
    dtype = model.dtype

    y = jnp.asarray(grid_ints, dtype=dtype)
    inv_sigma2 = 1.0 / jnp.asarray(grid_yerrs, dtype=dtype) ** 2
    axis_name = LINE_AXIS if n_l > 1 else None

    def chi2_lnprob(m, lp):
        resid = y - m
        ll = -0.5 * jnp.sum(resid * resid * inv_sigma2 - jnp.log(inv_sigma2),
                            axis=-1)
        return jnp.where(jnp.isfinite(lp) & jnp.isfinite(ll), lp + ll, -jnp.inf)

    if use_pallas:
        from cha1_mcmc_tpu.inference.likelihood import _batched_opacity_model
        from cha1_mcmc_tpu.models.opacity import (build_opacity_gather_sharded,
                                                  opacity_gather)

        if dv_max is None:
            raise ValueError("use_pallas=True requires dv_max (from prior bounds)")
        table, vel_t, active = build_opacity_gather_sharded(
            np.asarray(model.vel_grid), model.mask_center, dv_max, n_l)
        # Each shard's active lines, padded with zero-opacity lines (aij = 0)
        # up to the common count; taus are computed only for these.
        pad = active < 0
        take = np.where(pad, 0, active)

        def shard_lines(arr, fill):
            return jnp.asarray(np.where(pad, fill, np.asarray(arr)[take]), dtype)

        line_args = (shard_lines(model.line_freq, 1.0),
                     shard_lines(model.line_elower, 0.0),
                     shard_lines(model.line_aij, 0.0),
                     shard_lines(model.line_gup, 1.0),
                     shard_lines(model.line_glow, 1.0),
                     jnp.asarray(table), jnp.asarray(vel_t, dtype))

        def local_lnprob_batch(lines_local, thetas):
            *lines, tab, vel = lines_local
            thetas = jnp.asarray(thetas, dtype=dtype)
            m = _batched_opacity_model(
                lambda t, v, d: opacity_gather(t, v, d, tab, vel,
                                               mask_center=model.mask_center),
                *lines, model.q_model, model.grid_freq, model.dish_size,
                model.Tbg, dtype, spec, thetas, axis_name=axis_name)
            return chi2_lnprob(m, jax.vmap(lnprior_fn)(thetas))
    else:
        line_args = (model.line_freq, model.line_elower, model.line_aij,
                     model.line_gup, model.line_glow, model.vel_grid)

        def local_lnprob(lines_local, theta):
            lf, le, la, lg, lgl, vg = lines_local
            ss, Ncol, Tex, vlsr, dV = spec.unpack(jnp.asarray(theta, dtype=dtype))
            m = forward_from_lines(
                lf, le, la, lg, lgl, vg, model.q_model, model.grid_freq,
                model.mask_center, model.dish_size, model.Tbg, dtype,
                ss, Ncol, Tex, vlsr, dV, axis_name=axis_name)
            return chi2_lnprob(m, lnprior_fn(theta))

        local_lnprob_batch = jax.vmap(local_lnprob, in_axes=(None, 0))

    line_specs = tuple(P(LINE_AXIS) if a.ndim == 1 else P(LINE_AXIS, None)
                       for a in line_args)
    # Placed on the mesh once, so a call does not reshard them again.
    line_args = tuple(jax.device_put(a, NamedSharding(mesh, s))
                      for a, s in zip(line_args, line_specs))
    return line_args, line_specs, local_lnprob_batch


def make_sharded_lnprob(model: SpectralModel, spec: ParamSpec, grid_ints,
                        grid_yerrs, lnprior_fn, mesh: Mesh,
                        use_pallas: bool = False, dv_max: float | None = None):
    """Jitted `lnprob(thetas (W, D)) -> (W,)` evaluated over `mesh`: walkers
    split over ('chains', 'walkers'), catalog lines over 'lines' — the same
    per-device lnprob the sharded sampler runs, for checking it against
    the single-device builders."""
    line_args, line_specs, local_lnprob_batch = _local_lnprob(
        model, spec, grid_ints, grid_yerrs, lnprior_fn, mesh, use_pallas,
        dv_max)
    w_spec = P((CHAIN_AXIS, WALKER_AXIS))
    fn = jax.jit(shard_map(
        local_lnprob_batch, mesh=mesh,
        in_specs=(line_specs, P((CHAIN_AXIS, WALKER_AXIS), None)),
        out_specs=w_spec, check_vma=False))
    return lambda thetas: fn(line_args, jnp.asarray(thetas, model.dtype))


def make_sharded_runner(
    model: SpectralModel,
    spec: ParamSpec,
    grid_ints,
    grid_yerrs,
    lnprior_fn,
    mesh: Mesh,
    nsteps: int,
    a: float = 2.0,
    use_pallas: bool = False,
    dv_max: float | None = None,
):
    """Build a jitted `runner(pos0, key) -> (chain, lnps, accepted,
    (pos, lnp))` executing `nsteps` sharded stretch-move steps.

    use_pallas selects the per-shard opacity formulation (_local_lnprob).

    The returned callable is reusable across blocks (the jit cache is keyed
    on it), which is what makes checkpointed block execution compile once
    per block size instead of once per block.
    """
    n_w = mesh.shape[WALKER_AXIS]
    dtype = model.dtype
    line_args, line_specs, local_lnprob_batch = _local_lnprob(
        model, spec, grid_ints, grid_yerrs, lnprior_fn, mesh, use_pallas,
        dv_max)
    # The global walker dim partitions over (chains, walkers): whole
    # chains contiguous, matching MultiChainSampler's pooled (K*W, S, D)
    # layout so gelman_rubin measures cross-chain mixing unchanged.
    W_SPEC = (CHAIN_AXIS, WALKER_AXIS)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(line_specs, P(W_SPEC, None), P()),
        out_specs=(P(None, W_SPEC, None), P(None, W_SPEC), P(),
                   P(W_SPEC, None), P(W_SPEC)),
        check_vma=False,
    )
    def sharded_run(lines_local, pos_local, key):
        # Distinct randomness per (chain, walker-shard); a walker shard's
        # devices across the lines axis stay in lockstep.
        w_idx = (jax.lax.axis_index(CHAIN_AXIS) * mesh.shape[WALKER_AXIS]
                 + jax.lax.axis_index(WALKER_AXIS))
        lnprob_batch = partial(local_lnprob_batch, lines_local)
        lnp_local = lnprob_batch(pos_local)
        W_local, D = pos_local.shape
        h = W_local // 2

        # Bulk pre-generated randomness per device; the walker-shard fold
        # keeps a walker shard's devices (across the lines axis) in lockstep
        # while different shards draw independently.
        k = jax.random.fold_in(key, w_idx)
        k_perm, k_z, k_pair, k_acc = jax.random.split(k, 4)
        # Randomized per-device half-split per step (argsort of uniforms);
        # see the module docstring for how this maps emcee's global
        # randomize_split onto a sharded ensemble.
        perms = jnp.argsort(
            jax.random.uniform(k_perm, (nsteps, W_local)), axis=1)
        z_u = jax.random.uniform(k_z, (nsteps, 2, h), dtype=pos_local.dtype)
        n_comp = h * mesh.shape[WALKER_AXIS]
        pair = jax.random.randint(k_pair, (nsteps, 2, h), 0, n_comp)
        acc_u = jax.random.uniform(k_acc, (nsteps, 2, h), dtype=pos_local.dtype)

        def one_step(carry, xs):
            coords, lnp = carry
            perm, zu, pr, au = xs
            first, second = perm[:h], perm[h:]
            coords, lnp, a0 = _half_step_sharded(lnprob_batch, D, a, coords, lnp,
                                                 first, second, zu[0], pr[0], au[0])
            coords, lnp, a1 = _half_step_sharded(lnprob_batch, D, a, coords, lnp,
                                                 second, first, zu[1], pr[1], au[1])
            acc = jax.lax.psum(a0 + a1, (CHAIN_AXIS, WALKER_AXIS))
            return (coords, lnp), (coords, lnp, acc)

        (pos, lnp), (chain, lnps, accepted) = jax.lax.scan(
            one_step, (pos_local, lnp_local), (perms, z_u, pair, acc_u))
        return chain, lnps, accepted, pos, lnp

    jitted = jax.jit(sharded_run)

    def runner(pos0, key):
        W, D = pos0.shape
        n_c = mesh.shape[CHAIN_AXIS]
        if W % (2 * n_c * n_w):
            raise ValueError(
                f"nwalkers={W} must be divisible by 2 * {n_c} chains * "
                f"{n_w} walker shards")
        pos0 = jax.device_put(jnp.asarray(pos0, dtype=dtype))
        chain, lnps, accepted, pos, lnp = jitted(line_args, pos0, key)
        return chain, lnps, accepted, (pos, lnp)

    return runner


def run_ensemble_sharded(
    model: SpectralModel,
    spec: ParamSpec,
    grid_ints,
    grid_yerrs,
    lnprior_fn,
    pos0,
    key,
    nsteps: int,
    mesh: Mesh,
    a: float = 2.0,
    use_pallas: bool = False,
    dv_max: float | None = None,
):
    """Run `nsteps` stretch-move steps with walkers and catalog lines sharded.

    pos0: (W, D) with W divisible by 2 * mesh walker shards. Returns
    (chain (nsteps, W, D), lnps (nsteps, W), accepted (nsteps,),
    final (pos, lnp)) as global arrays. One-shot convenience over
    make_sharded_runner (which callers with block checkpointing should use
    directly to reuse the compiled executable).
    """
    runner = make_sharded_runner(
        model, spec, grid_ints, grid_yerrs, lnprior_fn, mesh, nsteps, a=a,
        use_pallas=use_pallas, dv_max=dv_max)
    return runner(pos0, key)


@dataclasses.dataclass
class ShardedEnsembleSampler(EnsembleSampler):
    """Multi-device EnsembleSampler: same chain-file / checkpoint / resume
    contract as the single-device sampler, executed over a
    ('chains', 'walkers', 'lines') mesh.

    This is what `FitConfig.n_devices` routes to — the replacement for
    the reference's multiprocessing pool fan-out (reference
    inference.py:456-463) with the pipeline's full persistence contract
    (cumulative chain .npy + .state.npz sidecar, block retries).
    """

    mesh: Mesh = None
    model: SpectralModel = None
    spec: ParamSpec = None
    grid_ints: object = None
    grid_yerrs: object = None
    lnprior_fn: object = None
    use_pallas: bool = False
    dv_max: float | None = None

    def __post_init__(self):
        super().__post_init__()
        if self.mesh is None or self.model is None:
            raise ValueError("ShardedEnsembleSampler requires mesh and model")
        self._runners: dict[int, object] = {}

    def _runner(self, nsteps: int):
        if nsteps not in self._runners:
            self._runners[nsteps] = make_sharded_runner(
                self.model, self.spec, self.grid_ints, self.grid_yerrs,
                self.lnprior_fn, self.mesh, nsteps, a=self.a,
                use_pallas=self.use_pallas, dv_max=self.dv_max)
        return self._runners[nsteps]

    def _init_lnp(self, pos):
        # The sharded runner recomputes local lnp from positions inside the
        # mesh program (deterministic, so resume stays exact); no host-side
        # lnprob evaluation exists or is needed.
        return jnp.zeros(pos.shape[0], dtype=self.dtype)

    def _run_block(self, pos, lnp, key, nsteps: int, thin: int):
        # Thinning is exact subsampling of the raw trajectory: advance
        # nsteps * thin raw moves in one mesh program and record every
        # thin-th state (identical trajectory to thin=1 on the same key).
        chain, lnps, acc, final = self._runner(nsteps * thin)(pos, key)
        if thin == 1:
            return chain, lnps, acc, final
        return (chain[thin - 1::thin], lnps[thin - 1::thin],
                acc.reshape(nsteps, thin).sum(axis=1), final)


def make_sharded_sampler(*, n_devices: int, n_line_shards: int, nwalkers: int,
                         ndim: int, a: float, dtype, model, spec, grid_ints,
                         grid_yerrs, lnprior_fn, use_pallas: bool = False,
                         dv_max: float | None = None, n_chains: int = 1,
                         verbose: bool = True) -> "ShardedEnsembleSampler":
    """Validate the mesh request and construct a ShardedEnsembleSampler —
    the single construction point shared by the single-component
    (pipeline/fit.py) and multi-component (pipeline/multifit.py) drivers.

    n_chains > 1 composes K independent ensembles with the device mesh
    (a 'chains' axis no collective crosses): each chain owns
    n_devices / (n_chains * n_line_shards) walker shards, and the pooled
    chain keeps whole chains contiguous for honest cross-chain R-hat."""
    if n_devices > len(jax.devices()):
        raise ValueError(f"n_devices={n_devices} exceeds the "
                         f"{len(jax.devices())} available devices")
    if n_devices % (n_line_shards * n_chains):
        raise ValueError(f"n_devices={n_devices} must be divisible by "
                         f"n_line_shards={n_line_shards} * "
                         f"n_chains={n_chains}")
    if nwalkers % n_chains:
        raise ValueError(f"nwalkers={nwalkers} must be divisible by "
                         f"n_chains={n_chains}")
    mesh = make_mesh(n_devices // (n_line_shards * n_chains), n_line_shards,
                     n_chain_shards=n_chains)
    if verbose:
        from cha1_mcmc_tpu.constants import GRAY, RESET

        chains_txt = (f"chains={n_chains}, " if n_chains > 1 else "")
        opacity_txt = ", sparse gather opacity" if use_pallas else ""
        print(f"{GRAY}Sampling on a {n_devices}-device mesh "
              f"({chains_txt}walkers={mesh.shape[WALKER_AXIS]}, "
              f"lines={mesh.shape[LINE_AXIS]}{opacity_txt}).{RESET}")
    return ShardedEnsembleSampler(
        lnprob_fn=None, nwalkers=nwalkers, ndim=ndim, a=a, dtype=dtype,
        mesh=mesh, model=model, spec=spec, grid_ints=grid_ints,
        grid_yerrs=grid_yerrs, lnprior_fn=lnprior_fn, use_pallas=use_pallas,
        dv_max=dv_max)
