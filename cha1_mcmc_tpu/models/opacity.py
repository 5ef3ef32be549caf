"""Sparse Gaussian opacity: the channel-major gather formulation.

The hot contraction of the likelihood is
    opac[w, c] = sum_l tau[w, l] * 1{|v[l,c] - center| < 10 dV_w}
                 * exp(-0.5 ((v[l,c] - vlsr_w) / (dV_w / 2.355))^2)

(reference inference.py:50-53 computes this per line in a Numba loop).
The dense jnp path materializes the (W, L, C) Gaussian intermediate, which
for dense aromatic catalogs (35k+ transitions, reference
catalog/1-cyanonapthalene.cat) is tens of GB of memory traffic per ensemble
step, almost all of it zeros outside the +-10 dV window. The tables below
transpose that sparsity into a static per-channel gather, in plain jnp.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from cha1_mcmc_tpu.constants import FWHM_TO_SIGMA_MODEL, VELOCITY_WINDOW_DV

__all__ = ["build_opacity_gather", "build_opacity_gather_sharded",
           "opacity_gather", "heavy_scatter_onehot",
           "build_opacity_gather_split", "opacity_gather_split"]


# ---------------------------------------------------------------------------
# Channel-major gather formulation: the window sparsity transposed. Each
# line's ±10·dV window covers only a few channels of a coarse survey grid
# (1-cyanonaphthalene @ 2048 channels: 4,972 in-window (line, channel) pairs
# out of 72.6M — 2.4 contributing lines per channel on average, max 46).
# Here the static table is per *channel*: line_table[m, c] lists the lines
# whose widest-possible window covers channel c. The opacity becomes a
# gather + (W, M, C) elementwise Gaussian + a length-M reduction — plain jnp
# that XLA fuses, with M ~ tens instead of L ~ tens of thousands. Lines
# that cover no channel at all are dropped from the tau computation too
# (the `active` subset).
# ---------------------------------------------------------------------------


def build_opacity_gather(vel_grid: np.ndarray, mask_center: float,
                         dv_max: float):
    """Static channel-major gather tables for opacity_gather.

    Returns (line_table (M, C) int32, vel_t (M, C) f32, active (La,) int64):
    line_table[m, c] indexes into the `active` line subset (the caller
    computes taus only for catalog lines `active`); vel_t[m, c] is that
    line's velocity at channel c. M is the max number of in-window lines
    over channels. Padding entries carry vel 1e30 (Gaussian exactly 0 in
    f32) and line index 0. Static per (datagrid, prior dV bound).
    """
    vel_grid = np.asarray(vel_grid)
    L, C = vel_grid.shape
    inside = np.abs(vel_grid - mask_center) < VELOCITY_WINDOW_DV * dv_max
    counts = inside.sum(axis=0)
    M = max(int(counts.max()), 1)
    active = np.flatnonzero(inside.any(axis=1))
    if active.size == 0:
        active = np.array([0], dtype=np.int64)
    remap = np.zeros(L, dtype=np.int32)
    remap[active] = np.arange(active.size, dtype=np.int32)
    line_table = np.zeros((M, C), dtype=np.int32)
    vel_t = np.full((M, C), 1e30, dtype=vel_grid.dtype)
    for c in np.flatnonzero(counts):
        idx = np.flatnonzero(inside[:, c])
        line_table[:idx.size, c] = remap[idx]
        vel_t[:idx.size, c] = vel_grid[idx, c]
    return line_table, vel_t, active


def build_opacity_gather_sharded(vel_grid: np.ndarray, mask_center: float,
                                 dv_max: float, n_shards: int):
    """Per-shard gather tables for a catalog whose lines are split into
    `n_shards` contiguous, equal blocks (the mesh's 'lines' axis).

    Each shard gets build_opacity_gather's tables over its own lines,
    padded to the largest shard's M (vel 1e30, Gaussian exactly 0) and
    active-line count La (index -1: the caller gives padding lines zero
    opacity). Returns (line_table (n*M, C) int32 indexing the shard's own
    active subset, vel_t (n*M, C), active (n*La,) int64 GLOBAL line
    indices or -1) — row blocks of n equal parts, so sharding the leading
    axis over the mesh hands each device its own tables.
    """
    vel_grid = np.asarray(vel_grid)
    L, C = vel_grid.shape
    if L % n_shards:
        raise ValueError(f"{L} lines do not split into {n_shards} shards")
    per = L // n_shards
    shards = [build_opacity_gather(vel_grid[s * per:(s + 1) * per],
                                   mask_center, dv_max)
              for s in range(n_shards)]
    M = max(t.shape[0] for t, _, _ in shards)
    La = max(a.size for _, _, a in shards)
    table = np.zeros((n_shards, M, C), dtype=np.int32)
    vel_t = np.full((n_shards, M, C), 1e30, dtype=vel_grid.dtype)
    active = np.full((n_shards, La), -1, dtype=np.int64)
    for s, (t, v, a) in enumerate(shards):
        table[s, :t.shape[0]] = t
        vel_t[s, :t.shape[0]] = v
        active[s, :a.size] = a + s * per
    return (table.reshape(n_shards * M, C), vel_t.reshape(n_shards * M, C),
            active.reshape(-1))


@functools.partial(jax.jit, static_argnames=("mask_center",))
def opacity_gather(taus, vlsr, dV, line_table, vel_t, *, mask_center: float):
    """Accumulated Gaussian opacity via the channel-major gather, (W, C).

    taus: (W, La) over the active-line subset from build_opacity_gather;
    vlsr, dV: (W,); line_table/vel_t: (M, C). Exact ±10·dV window
    semantics (the per-walker window select is kept — it is M-cheap here).
    """
    sigma = (dV / FWHM_TO_SIGMA_MODEL)[:, None, None]
    window = jnp.abs(vel_t - mask_center) < (
        VELOCITY_WINDOW_DV * dV[:, None, None])
    z = (vel_t - vlsr[:, None, None]) / sigma
    gauss = jnp.where(window, jnp.exp(-0.5 * z * z), 0.0)   # (W, M, C)
    tau_g = jnp.take(taus, line_table, axis=-1)             # (W, M, C)
    return jnp.sum(tau_g * gauss, axis=-2)


# ---------------------------------------------------------------------------
# Two-class split of the channel-major gather. The rectangular (M, C) table
# is padded to the *maximum* per-channel line count, but the distribution is
# extremely skewed on dense catalogs (1-cyanonaphthalene @ 2048 channels:
# mean 2.4 lines/channel, max 46 — ~95% of the (M, C) work is padding). The
# split keeps a short (M1, C) table covering every channel's first M1 lines
# and moves the overflow of the few "heavy" channels (hfs clusters /
# line-dense regions) into a second (M2, C2) table over just those C2
# channels, scattered back into the full channel axis with an exact one-hot
# contraction: at HIGHEST precision every product is value x {0, 1} and
# each output column has one nonzero term, so it reconstructs the f32
# value bit for bit (a TF32 or bf16 pass would round it).
# ---------------------------------------------------------------------------


def heavy_scatter_onehot(heavy: np.ndarray, n_channels: int) -> np.ndarray:
    """(C2, C) f32 one-hot scatter matrix mapping the heavy-channel
    overflow columns of build_opacity_gather_split back to their channel
    positions — contracted exactly by opacity_gather_split
    (value x {0, 1} at HIGHEST precision)."""
    onehot = np.zeros((len(heavy), n_channels), dtype=np.float32)
    onehot[np.arange(len(heavy)), heavy] = 1.0
    return onehot


def build_opacity_gather_split(vel_grid: np.ndarray, mask_center: float,
                               dv_max: float, m1: int | None = None,
                               min_saving: float = 1.3):
    """Two-class channel-major gather tables, or None when not worthwhile.

    Returns (table1 (M1, C), vel1 (M1, C), table2 (M2, C2), vel2 (M2, C2),
    heavy (C2,) int64 channel indices, active (La,) int64) with the same
    index/velocity conventions as build_opacity_gather: tables index the
    `active` line subset, padding entries carry vel 1e30 (Gaussian exactly
    0 in f32) and line index 0. M1 is chosen to minimise the modeled
    element work C*M1 + C2*M2; returns None unless that beats the
    rectangular table's M*C by at least `min_saving` x (then callers use
    the plain gather)."""
    vel_grid = np.asarray(vel_grid)
    L, C = vel_grid.shape
    inside = np.abs(vel_grid - mask_center) < VELOCITY_WINDOW_DV * dv_max
    counts = inside.sum(axis=0)
    M = max(int(counts.max()), 1)

    def split_work(cand):
        c2 = int((counts > cand).sum())
        m2 = int(max(counts.max() - cand, 0)) if c2 else 0
        return C * cand + c2 * m2

    if m1 is not None:
        # A caller-chosen m1 is screened against ITS OWN work model, not
        # the work-optimal one the search would pick.
        chosen = (m1, split_work(m1))
    else:
        chosen = min(((cand, split_work(cand)) for cand in range(1, M)),
                     key=lambda t: t[1], default=None)
    if chosen is None or M * C < min_saving * chosen[1]:
        return None
    m1 = chosen[0]
    active = np.flatnonzero(inside.any(axis=1))
    if active.size == 0:
        active = np.array([0], dtype=np.int64)
    remap = np.zeros(L, dtype=np.int32)
    remap[active] = np.arange(active.size, dtype=np.int32)
    heavy = np.flatnonzero(counts > m1)
    M2 = max(int((counts[heavy] - m1).max()), 1) if heavy.size else 1
    table1 = np.zeros((m1, C), dtype=np.int32)
    vel1 = np.full((m1, C), 1e30, dtype=vel_grid.dtype)
    table2 = np.zeros((M2, max(heavy.size, 1)), dtype=np.int32)
    vel2 = np.full((M2, max(heavy.size, 1)), 1e30, dtype=vel_grid.dtype)
    for c in np.flatnonzero(counts):
        idx = np.flatnonzero(inside[:, c])
        k = min(idx.size, m1)
        table1[:k, c] = remap[idx[:k]]
        vel1[:k, c] = vel_grid[idx[:k], c]
    for j, c in enumerate(heavy):
        idx = np.flatnonzero(inside[:, c])[m1:]
        table2[:idx.size, j] = remap[idx]
        vel2[:idx.size, j] = vel_grid[idx, c]
    if heavy.size == 0:
        heavy = np.array([0], dtype=np.int64)
    return table1, vel1, table2, vel2, heavy, active


@functools.partial(jax.jit, static_argnames=("mask_center",))
def opacity_gather_split(taus, vlsr, dV, table1, vel1, table2, vel2,
                         heavy_onehot, *, mask_center: float):
    """Accumulated Gaussian opacity via the split gather, (W, C).

    Same semantics as opacity_gather. heavy_onehot is the (C2, C) f32
    one-hot scatter matrix for the heavy-channel overflow table (row j has
    a single 1 at column heavy[j]); the contraction runs at HIGHEST
    precision so the scattered overflow partial is f32-exact. Light
    channels (count <= M1) are bitwise-identical to the plain gather
    (their overflow partial is exactly 0.0); heavy channels differ only
    by the f32 reassociation of splitting the line sum in two."""
    part1 = opacity_gather(taus, vlsr, dV, table1, vel1,
                           mask_center=mask_center)         # (W, C)
    part2 = opacity_gather(taus, vlsr, dV, table2, vel2,
                           mask_center=mask_center)         # (W, C2)
    return part1 + jnp.dot(part2, heavy_onehot,
                           preferred_element_type=part1.dtype,
                           precision=jax.lax.Precision.HIGHEST)
