"""Goodman & Weare affine-invariant stretch-move ensemble sampler.

Semantics match emcee v3's StretchMove + RedBlueMove driver, which the
reference uses as its sampling engine (reference inference.py:456-473,
requirements.txt pin emcee==3.1.6):

  * per step the ensemble is split into two random halves
    (RedBlueMove randomize_split);
  * halves update sequentially — the second half sees the first half's
    *updated* coordinates;
  * each active walker draws a partner uniformly from the complementary
    half, a stretch factor z with density g(z) = 1/sqrt(z) on [1/a, a]
    via z = ((a-1) u + 1)^2 / a, and proposes Y = c + z (s - c);
  * acceptance: ln U < (ndim - 1) ln z + lnprob(Y) - lnprob(s).

Device realization: the whole chain is one `lax.scan` over steps; each
half-update evaluates the vmapped lnprob for W/2 proposals in one device
program. The reference instead ships each walker's theta to a
forked CPU process through pickled pipes (reference inference.py:456-463).
Fixed PRNG keys make chains bitwise reproducible.
"""

from __future__ import annotations

import dataclasses
import logging
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.errors import JaxRuntimeError as _DeviceError

from cha1_mcmc_tpu.sampler.chain import last_position

__all__ = ["run_ensemble", "run_ensemble_chains", "EnsembleSampler",
           "MultiChainSampler"]

logger = logging.getLogger(__name__)


class _PlainProgress:
    """Per-block progress line, for hosts without tqdm."""

    def __init__(self, total: int):
        self.total, self.done = total, 0

    def update(self, n: int) -> None:
        self.done += n
        print(f"MCMC sampling: {self.done}/{self.total} steps", flush=True)

    def close(self) -> None:
        pass


def _progress(total: int):
    try:
        from tqdm import tqdm
    except ImportError:
        return _PlainProgress(total)
    return tqdm(total=total, desc="MCMC sampling", colour="white")


def _state_path(chain_file: str) -> str:
    import os

    root, _ = os.path.splitext(chain_file)
    return root + ".state.npz"


def _half_step(lnprob_batch, ndim, a, coords, lnp, active_idx, comp_idx,
               z_u, pair, acc_u):
    """Update walkers `active_idx` using complement `comp_idx` with
    pre-generated uniforms. Returns (coords, lnp, n_accepted)."""
    s = coords[active_idx]
    c = coords[comp_idx][pair]
    z = ((a - 1.0) * z_u + 1.0) ** 2 / a
    proposal = c + z[:, None] * (s - c)

    lnp_new = lnprob_batch(proposal)
    lnpdiff = (ndim - 1.0) * jnp.log(z) + lnp_new - lnp[active_idx]
    accept = jnp.log(acc_u) < lnpdiff

    coords = coords.at[active_idx].set(jnp.where(accept[:, None], proposal, s))
    lnp = lnp.at[active_idx].set(jnp.where(accept, lnp_new, lnp[active_idx]))
    return coords, lnp, jnp.sum(accept)


@partial(jax.jit, static_argnames=("lnprob_fn", "nsteps", "a", "thin", "batched"))
def run_ensemble(lnprob_fn, pos0, lnp0, key, nsteps: int, a: float = 2.0,
                 thin: int = 1, batched: bool = False):
    """Run `nsteps` ensemble steps from (pos0, lnp0).

    lnprob_fn: scalar theta -> lnprob (vmapped internally), or — with
    batched=True — an explicitly batched (N, D) -> (N,) function (e.g.
    build_lnprob_batched).
    pos0: (W, D) initial walker coordinates; lnp0: (W,) their lnprob.
    Each of the `nsteps` recorded steps advances the ensemble by `thin`
    raw ensemble moves. Returns (chain (nsteps, W, D), lnps (nsteps, W),
    accepted (nsteps,), final (pos, lnp)).

    All randomness is generated upfront in four bulk ops and consumed as
    scan inputs, which keeps per-step key splitting out of the scan body
    (about 2.4x fewer ops per step). Memory for the
    pre-generated uniforms is ~16 * nsteps * thin * W bytes — callers with
    very long runs should block them (EnsembleSampler checkpoints do).
    """
    W, D = pos0.shape
    if W % 2:
        raise ValueError(f"nwalkers={W} must be even (complementary halves)")
    h = W // 2
    n_raw = nsteps * thin
    lnprob_batch = lnprob_fn if batched else jax.vmap(lnprob_fn)
    dtype = pos0.dtype

    k_perm, k_z, k_pair, k_acc = jax.random.split(key, 4)
    # Randomized half-split per raw step via argsort of uniforms
    # (equivalent in distribution to emcee's shuffled index split).
    perms = jnp.argsort(jax.random.uniform(k_perm, (n_raw, W)), axis=1)
    z_u = jax.random.uniform(k_z, (n_raw, 2, h), dtype=dtype)
    pair = jax.random.randint(k_pair, (n_raw, 2, h), 0, h)
    acc_u = jax.random.uniform(k_acc, (n_raw, 2, h), dtype=dtype)

    def one_step(carry, xs):
        coords, lnp = carry
        perm, zu, pr, au = xs
        first, second = perm[:h], perm[h:]
        coords, lnp, acc0 = _half_step(lnprob_batch, D, a, coords, lnp,
                                       first, second, zu[0], pr[0], au[0])
        coords, lnp, acc1 = _half_step(lnprob_batch, D, a, coords, lnp,
                                       second, first, zu[1], pr[1], au[1])
        return (coords, lnp), acc0 + acc1

    xs = (perms, z_u, pair, acc_u)
    if thin == 1:
        def thinned_step(carry, x):
            carry, acc = one_step(carry, x)
            coords, lnp = carry
            return carry, (coords, lnp, acc)
    else:
        xs = jax.tree.map(lambda t: t.reshape((nsteps, thin) + t.shape[1:]), xs)

        def thinned_step(carry, x):
            carry, accs = jax.lax.scan(one_step, carry, x)
            coords, lnp = carry
            return carry, (coords, lnp, jnp.sum(accs))

    (pos, lnp), (chain, lnps, accepted) = jax.lax.scan(thinned_step, (pos0, lnp0), xs)
    return chain, lnps, accepted, (pos, lnp)


def run_ensemble_chains(lnprob_fn, pos0, lnp0, keys, nsteps: int, a: float = 2.0,
                        thin: int = 1, batched: bool = False):
    """Run K independent ensembles concurrently (vmapped over the chain
    axis) — saturates the device at small per-chain walker counts (throughput
    scales like a single ensemble of K*W walkers) and feeds cross-chain
    R-hat diagnostics.

    pos0: (K, W, D); lnp0: (K, W); keys: (K,) PRNG keys (e.g.
    jax.random.split(key, K)). Returns per-chain stacked results:
    chain (K, nsteps, W, D), lnps (K, nsteps, W), accepted (K, nsteps),
    final (pos (K, W, D), lnp (K, W)).
    """
    inner = partial(run_ensemble, lnprob_fn, nsteps=nsteps, a=a, thin=thin,
                    batched=batched)
    return jax.vmap(lambda p, l, k: inner(p, l, k))(pos0, lnp0, keys)


@dataclasses.dataclass
class EnsembleSampler:
    """Stateful convenience wrapper with the reference chain-file contract.

    The reference drives emcee one step at a time, saving the cumulative
    chain as a (nwalkers, nsteps, ndim) .npy after every step and resuming
    from chain[:, -1, :] (reference inference.py:460-473). At device speeds
    a per-step host write would dominate, so steps run on device in blocks of
    `checkpoint_every` and the same .npy contract is honored at block
    boundaries.
    """

    lnprob_fn: callable
    nwalkers: int
    ndim: int
    a: float = 2.0
    dtype: object = jnp.float32
    batched: bool = False  # lnprob_fn already maps (N, D) -> (N,)

    def __post_init__(self):
        self._chain_blocks: list[np.ndarray] = []   # each (W, K, D)
        self._lnp_blocks: list[np.ndarray] = []
        self.accepted = 0
        self.total_proposals = 0

    def preload(self, chain: np.ndarray, lnprobability: np.ndarray | None = None):
        """Seed the sampler with an existing (W, S, D) chain so further
        run_mcmc calls append to it — the cross-run resume convention
        (reference inference.py:462-463 re-saves the cumulative chain and
        restarts from chain[:, -1, :])."""
        chain = np.asarray(chain)
        assert chain.shape[0] == self.nwalkers and chain.shape[2] == self.ndim
        self._chain_blocks = [chain]
        self._lnp_blocks = ([np.asarray(lnprobability)] if lnprobability is not None
                            else [np.full(chain.shape[:2], np.nan)])
        return last_position(chain)

    @property
    def chain(self) -> np.ndarray:
        """(nwalkers, nsteps, ndim), emcee layout (reference inference.py:462)."""
        if not self._chain_blocks:
            return np.empty((self.nwalkers, 0, self.ndim))
        return np.concatenate(self._chain_blocks, axis=1)

    @property
    def lnprobability(self) -> np.ndarray:
        if not self._lnp_blocks:
            return np.empty((self.nwalkers, 0))
        return np.concatenate(self._lnp_blocks, axis=1)

    @property
    def acceptance_fraction(self) -> float:
        return self.accepted / max(self.total_proposals, 1)

    def _init_lnp(self, pos):
        return self.lnprob_fn(pos) if self.batched else jax.vmap(self.lnprob_fn)(pos)

    def _run_block(self, pos, lnp, key, nsteps: int, thin: int):
        """One checkpoint block; overridden by the sharded sampler."""
        return run_ensemble(self.lnprob_fn, pos, lnp, key, nsteps=nsteps,
                            a=self.a, thin=thin, batched=self.batched)

    def run_mcmc(self, pos, nsteps: int, key, checkpoint_every: int = 256,
                 chain_file: str | None = None, progress: bool = False,
                 thin: int = 1, max_retries: int = 2, lnp0=None):
        """Run `nsteps` steps, checkpointing the cumulative chain per block.

        Alongside the chain .npy, a `<chain>.state.npz` sidecar records the
        exact sampler state (positions, lnprob, PRNG key, acceptance
        counters) so a later run can continue the random stream exactly.
        A failed block (device fault, preemption — surfaced by JAX as a
        runtime error) is retried from the last checkpoint up to
        `max_retries` times with the *same* block key, so a fault-recovered
        chain is bitwise-identical to an unfaulted one. Program bugs
        (shape/type/value errors) are not retried — they propagate on first
        occurrence. This is the failure-recovery subsystem the reference
        approximates with its per-step np.save loop (reference
        inference.py:460-473).
        """
        pos = jnp.asarray(pos, dtype=self.dtype)
        # lnp0 (from load_state) continues with the *saved* lnp rather
        # than recomputing: a freshly-compiled lnprob program can round
        # its reductions differently, which could flip a marginal
        # acceptance and break bitwise resume parity.
        lnp = self._init_lnp(pos) if lnp0 is None else jnp.asarray(lnp0)
        done = 0
        retries = 0  # per-block; reset after each successful block
        iterator = _progress(nsteps) if progress else None
        while done < nsteps:
            block = min(checkpoint_every, nsteps - done)
            key, sub = jax.random.split(key)
            while True:
                try:
                    chain, lnps, accepted, (new_pos, new_lnp) = self._run_block(
                        pos, lnp, sub, block, thin)
                    chain_host = np.asarray(chain)  # materialize: surfaces device faults
                    break
                except _DeviceError:
                    if retries >= max_retries:
                        raise
                    retries += 1
                    logger.warning(
                        "device runtime error in MCMC block at step %d; "
                        "retrying with the same key (%d/%d)",
                        done, retries, max_retries)
            retries = 0
            pos, lnp = new_pos, new_lnp
            # device (K, W, D) -> emcee layout (W, K, D)
            self._chain_blocks.append(chain_host.transpose(1, 0, 2))
            self._lnp_blocks.append(np.asarray(lnps).T)
            self.accepted += int(np.asarray(accepted).sum())
            self.total_proposals += block * thin * self.nwalkers
            done += block
            if chain_file is not None:
                np.save(chain_file, self.chain)
                np.savez(_state_path(chain_file),
                         pos=np.asarray(pos), lnp=np.asarray(lnp),
                         key=np.asarray(key),
                         accepted=self.accepted,
                         total_proposals=self.total_proposals)
            if iterator is not None:
                iterator.update(block)
        if iterator is not None:
            iterator.close()
        return np.asarray(pos), np.asarray(lnp)

    def load_state(self, chain_file: str):
        """Restore (pos, lnp, key) from a `.state.npz` sidecar for an exact
        continuation (pass lnp to run_mcmc's lnp0); returns None if no
        sidecar exists."""
        import os

        state_path = _state_path(chain_file)
        if not os.path.exists(state_path):
            return None
        state = np.load(state_path)
        self.accepted = int(state["accepted"])
        self.total_proposals = int(state["total_proposals"])
        return (state["pos"], state["lnp"],
                jnp.asarray(state["key"], dtype=jnp.uint32))


@dataclasses.dataclass
class MultiChainSampler(EnsembleSampler):
    """K independent ensembles advanced concurrently (vmapped over the
    chain axis via run_ensemble_chains) with the same chain-file contract.

    The reference has no multi-chain concept; this exists because (a) at
    small per-chain walker counts independent chains saturate the device —
    throughput scales like one ensemble of K*W walkers — and (b) truly
    independent chains make the Gelman-Rubin R-hat an honest convergence
    gate. run_mcmc takes pos of shape (K, W, D); the recorded chain pools
    to the emcee (K*W, S, D) layout with whole chains contiguous, so
    `chain.reshape(K, W, S, D)` recovers per-chain histories and
    `diagnostics.gelman_rubin` on the pooled layout measures *cross-chain*
    mixing (each walker row already is a valid chain).
    """

    n_chains: int = 2  # nwalkers is the TOTAL (K * per-chain) walker count

    def __post_init__(self):
        super().__post_init__()
        if self.nwalkers % self.n_chains:
            raise ValueError(
                f"nwalkers={self.nwalkers} must be divisible by "
                f"n_chains={self.n_chains}")
        self.walkers_per_chain = self.nwalkers // self.n_chains

    def _shape_pos(self, pos):
        pos = jnp.asarray(pos, dtype=self.dtype)
        if pos.ndim == 2:  # pooled (K*W, D) — e.g. a resumed chain's tail
            pos = pos.reshape(self.n_chains, self.walkers_per_chain, -1)
        return pos

    def _init_lnp(self, pos):
        f = self.lnprob_fn if self.batched else jax.vmap(self.lnprob_fn)
        return jax.vmap(f)(self._shape_pos(pos))

    def _run_block(self, pos, lnp, key, nsteps: int, thin: int):
        pos = self._shape_pos(pos)
        keys = jax.random.split(key, self.n_chains)
        chain, lnps, acc, final = run_ensemble_chains(
            self.lnprob_fn, pos, lnp, keys, nsteps=nsteps, a=self.a,
            thin=thin, batched=self.batched)
        K, S, W, D = chain.shape
        # (K, S, W, D) -> (S, K*W, D): the base class transposes each block
        # to the pooled (K*W, S, D) emcee layout
        chain = jnp.transpose(chain, (1, 0, 2, 3)).reshape(S, K * W, D)
        lnps = jnp.transpose(lnps, (1, 0, 2)).reshape(S, K * W)
        return chain, lnps, jnp.sum(acc), final

    def run_mcmc(self, pos, nsteps: int, key, **kwargs):
        return super().run_mcmc(self._shape_pos(pos), nsteps, key, **kwargs)
