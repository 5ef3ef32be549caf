"""Independent-engine MCMC cross-validation: adaptive random-walk
Metropolis.

The reference validates its emcee pipeline against CASSIS's *independent*
MCMC engine (reference scripts/CASSIS/Cha1_HC5N_CASSIS.py:133
`computeChi2MinUsingMCMC`) — a sampler that shares nothing with emcee but
the posterior it targets. CASSIS is an external Java application and
genuine emcee is unobtainable in this environment (documented at
tests/test_convergence.py), so this module supplies that role natively:
an adaptive random-walk Metropolis engine whose move machinery shares
NOTHING with the stretch sampler — no ensemble coupling, no
complementary halves, no z ~ 1/sqrt(z) stretch draws, no walker pairing.
Each chain is an independent classic Metropolis walker with a Gaussian
proposal whose per-dimension widths are adapted during a warmup phase
(empirical spread + acceptance-targeted global scale, Haario-style) and
then FROZEN, so the sampling phase is exact fixed-kernel
Metropolis-Hastings and its stationary distribution is the posterior
with no adaptation bias. Agreement between the two engines' posteriors
is an engine-independent check of the whole lnprob stack, exactly the
role the CASSIS scripts play for the reference.

Device shape: the W chains are a batch axis of one jitted
`lax.scan` (proposals and acceptance uniforms pre-generated in bulk, as
in sampler/stretch.py), so the full sampling phase is a single device
program; the warmup is a short host loop over frozen-sigma scan rounds.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["run_adaptive_metropolis"]


def _make_mh_run(lnprob_batch):
    """Fixed-proposal Metropolis scan: nsteps x (propose, accept) for all
    W chains at once. sigma is a traced (D,) argument, so adaptation
    rounds reuse one compilation."""

    @partial(jax.jit, static_argnames=("nsteps",))
    def run(pos, lnp, sigma, key, nsteps: int):
        W, _ = pos.shape
        k_z, k_u = jax.random.split(key)
        zs = jax.random.normal(k_z, (nsteps,) + pos.shape, pos.dtype)
        # log U draws: -inf proposals (out of bounds / non-finite model,
        # reference inference.py:145-155 exception-to-rejection) make
        # lnpp - lnp = -inf and always reject.
        lnus = jnp.log(jax.random.uniform(k_u, (nsteps, W), pos.dtype))

        def body(carry, xs):
            pos, lnp = carry
            z, lnu = xs
            prop = pos + sigma * z
            lnpp = lnprob_batch(prop)
            ok = lnu < (lnpp - lnp)
            pos = jnp.where(ok[:, None], prop, pos)
            lnp = jnp.where(ok, lnpp, lnp)
            return (pos, lnp), (pos, lnp, ok.sum())

        (pos, lnp), (chain, lnps, acc) = lax.scan(body, (pos, lnp),
                                                  (zs, lnus))
        return chain, lnps, acc, (pos, lnp)

    return run


def run_adaptive_metropolis(lnprob_fn, pos0, key, *, nsteps: int,
                            init_sigma, warmup_rounds: int = 8,
                            round_len: int = 128,
                            target_accept: float = 0.3,
                            batched: bool = False):
    """Sample the posterior with W independent adaptive-Metropolis chains.

    lnprob_fn: scalar theta -> lnprob (vmapped internally), or — with
    batched=True — an explicitly batched (W, D) -> (W,) function.
    pos0: (W, D) initial chain positions (e.g. a prior-mean ball).
    init_sigma: (D,) initial proposal widths (prior stds / 10 works).
    Warmup runs `warmup_rounds` rounds of `round_len` frozen-sigma steps,
    after each blending the proposal widths toward the empirical
    per-dimension spread scaled by 2.38/sqrt(D) (the classic optimal-RWM
    rule) and nudging a global scale toward `target_accept`. The final
    `nsteps` phase runs with the proposal FROZEN (exact MH).

    Returns (chain (nsteps, W, D), lnps (nsteps, W), acceptance_fraction)
    — same chain layout as sampler.run_ensemble for direct comparison.
    """
    pos = jnp.asarray(pos0)
    W, D = pos.shape
    lnprob_batch = lnprob_fn if batched else jax.vmap(lnprob_fn)
    run = _make_mh_run(lnprob_batch)
    lnp = lnprob_batch(pos)

    sigma = np.asarray(init_sigma, dtype=np.float64).copy()
    if sigma.shape != (D,):
        raise ValueError(f"init_sigma must have shape ({D},)")
    scale = 1.0
    rwm = 2.38 / math.sqrt(D)
    for r in range(warmup_rounds):
        key, sub = jax.random.split(key)
        chain, _, acc, (pos, lnp) = run(
            pos, lnp, jnp.asarray(sigma * scale, pos.dtype), sub, round_len)
        afrac = float(np.sum(np.asarray(acc))) / (round_len * W)
        # Multiplicative acceptance targeting, clipped so one bad round
        # (e.g. afrac = 0 from an over-wide start) cannot overshoot.
        scale *= float(np.clip(math.exp(2.0 * (afrac - target_accept)),
                               0.5, 2.0))
        emp = np.asarray(chain)[round_len // 2:].reshape(-1, D).std(axis=0)
        # Geometric blend damps round-to-round noise; zero spread (a
        # dimension that never accepted this round) keeps its width.
        sigma = np.where(emp > 0, np.sqrt(sigma * rwm * emp), sigma)

    key, sub = jax.random.split(key)
    chain, lnps, acc, _ = run(
        pos, lnp, jnp.asarray(sigma * scale, pos.dtype), sub, nsteps)
    acceptance = float(np.sum(np.asarray(acc))) / (nsteps * W)
    return chain, lnps, acceptance
