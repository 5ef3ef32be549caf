"""Sparse channel-major gather opacity (models/opacity.py): correctness
against a dense float64 reference, and the batched likelihood path built
on it."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cha1_mcmc_tpu.models.opacity import (
    build_opacity_gather, build_opacity_gather_sharded,
    build_opacity_gather_split, heavy_scatter_onehot, opacity_gather,
    opacity_gather_split)
from cha1_mcmc_tpu.inference.likelihood import build_lnprob, build_lnprob_batched


def _random_problem(W=12, L=700, C=300, seed=0, center=4.10):
    rng = np.random.default_rng(seed)
    line_freq = np.sort(rng.uniform(18e3, 25e3, L))
    grid_freq = np.sort(rng.uniform(18e3, 25e3, C))
    vel = ((line_freq[:, None] - grid_freq[None, :]) / line_freq[:, None]
           * 2.998e5 + center).astype(np.float32)
    taus = rng.uniform(0, 0.1, (W, L)).astype(np.float32)
    vlsr = rng.uniform(center - 0.1, center + 0.2, W).astype(np.float32)
    dV = rng.uniform(0.5, 1.2, W).astype(np.float32)
    return vel, taus, vlsr, dV


def _dense_reference(vel, taus, vlsr, dV, center):
    sigma = dV[:, None, None] / 2.355
    window = np.abs(vel[None] - center) < 10 * dV[:, None, None]
    z = (vel[None].astype(np.float64) - vlsr[:, None, None]) / sigma
    return np.einsum("wl,wlc->wc", taus.astype(np.float64),
                     np.where(window, np.exp(-0.5 * z * z), 0.0))


def test_window_masking_at_extreme_vlsr():
    """Regression: with |vlsr - center| large relative to dV, the ±10·dV
    window select is NOT covered by f32 underflow (z at the window edge
    stays finite), so a formulation that dropped it would diverge ~35%
    from the reference window semantics. Both gather formulations keep
    the per-walker select and stay exact there."""
    center = 4.10
    vel, taus, vlsr, dV = _random_problem(12, 700, 300)
    # in-bounds for a wide prior box, far from the aligned velocity
    vlsr = np.full_like(vlsr, 9.9)
    dV = np.full_like(dV, 0.6)
    expected = _dense_reference(vel, taus, vlsr, dV, center)
    # without the window the same geometry is far from the reference
    sigma = dV[:, None, None] / 2.355
    z = (vel[None].astype(np.float64) - vlsr[:, None, None]) / sigma
    unwindowed = np.einsum("wl,wlc->wc", taus.astype(np.float64),
                           np.exp(-0.5 * z * z))
    assert np.abs(unwindowed - expected).max() > 1e-3

    table, vel_t, active = build_opacity_gather(vel, center, dv_max=1.5)
    plain = opacity_gather(jnp.asarray(taus[:, active]), jnp.asarray(vlsr),
                           jnp.asarray(dV), jnp.asarray(table),
                           jnp.asarray(vel_t), mask_center=center)
    np.testing.assert_allclose(np.asarray(plain), expected, rtol=2e-4,
                               atol=1e-6 * max(1.0, expected.max()))
    t1, v1, t2, v2, heavy, active_s = build_opacity_gather_split(
        vel, center, dv_max=1.5, min_saving=0.0)
    split = opacity_gather_split(
        jnp.asarray(taus[:, active_s]), jnp.asarray(vlsr), jnp.asarray(dV),
        jnp.asarray(t1), jnp.asarray(v1), jnp.asarray(t2), jnp.asarray(v2),
        jnp.asarray(heavy_scatter_onehot(heavy, vel.shape[1])),
        mask_center=center)
    np.testing.assert_allclose(np.asarray(split), expected, rtol=2e-4,
                               atol=1e-6 * max(1.0, expected.max()))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_opacity_gather_sharded_tables_match_dense(n_shards):
    """Per-shard gather tables (the line-sharded mesh path): summing each
    shard's gather over its own padded active lines reproduces the dense
    reference; padding entries are marked -1 and contribute nothing."""
    center = 4.10
    W, L, C = 6, 704, 300
    vel, taus, vlsr, dV = _random_problem(W, L, C, seed=4)
    expected = _dense_reference(vel, taus, vlsr, dV, center)
    table, vel_t, active = build_opacity_gather_sharded(vel, center, 1.5,
                                                        n_shards)
    M, La = table.shape[0] // n_shards, active.size // n_shards
    assert table.shape == vel_t.shape == (n_shards * M, C)
    total = np.zeros((W, C))
    for s in range(n_shards):
        act = active[s * La:(s + 1) * La]
        assert ((act == -1) | ((act >= s * L // n_shards)
                               & (act < (s + 1) * L // n_shards))).all()
        shard_taus = np.where(act >= 0, taus[:, np.maximum(act, 0)], 0.0)
        total += np.asarray(opacity_gather(
            jnp.asarray(shard_taus, jnp.float32), jnp.asarray(vlsr),
            jnp.asarray(dV), jnp.asarray(table[s * M:(s + 1) * M]),
            jnp.asarray(vel_t[s * M:(s + 1) * M]), mask_center=center))
    np.testing.assert_allclose(total, expected, rtol=2e-4,
                               atol=1e-6 * max(1.0, expected.max()))
    with pytest.raises(ValueError):
        build_opacity_gather_sharded(vel, center, 1.5, 3)


def test_batched_lnprob_matches_scalar_vmap(hc5n_problem, hc5n_datagrid):
    """The batched builder (jnp path) agrees with vmap of the scalar path."""
    model, spec, lnprior = (hc5n_problem["model"], hc5n_problem["spec"],
                            hc5n_problem["lnprior"])
    grid = hc5n_datagrid
    scalar = jax.vmap(build_lnprob(model, spec, grid.ints, grid.yerrs, lnprior))
    batched = build_lnprob_batched(model, spec, grid.ints, grid.yerrs, lnprior)
    rng = np.random.default_rng(0)
    thetas = np.array([3.24e12, 7.5, 4.11, 0.78]) * (
        1 + 0.02 * rng.standard_normal((16, 4)))
    a = np.asarray(scalar(jnp.asarray(thetas, jnp.float32)))
    b = np.asarray(batched(jnp.asarray(thetas, jnp.float32)))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-3)


def test_batched_lnprob_pallas_path(hc5n_problem, hc5n_datagrid):
    """The sparse-gather batched lnprob (use_pallas=True) agrees with the
    dense jnp path and propagates -inf for out-of-bounds walkers."""
    model, spec, lnprior = (hc5n_problem["model"], hc5n_problem["spec"],
                            hc5n_problem["lnprior"])
    grid = hc5n_datagrid
    jnp_path = build_lnprob_batched(model, spec, grid.ints, grid.yerrs, lnprior)
    rng = np.random.default_rng(1)
    thetas = np.array([3.24e12, 7.5, 4.11, 0.78]) * (
        1 + 0.02 * rng.standard_normal((8, 4)))
    thetas[3] = [1e15, 8.0, 4.3, 0.7]  # out of bounds
    a = np.asarray(jnp_path(jnp.asarray(thetas, jnp.float32)))
    assert a[3] == -np.inf
    keep = np.isfinite(a)
    gather_path = build_lnprob_batched(
        model, spec, grid.ints, grid.yerrs, lnprior, use_pallas=True,
        dv_max=1.5)
    b = np.asarray(gather_path(jnp.asarray(thetas, jnp.float32)))
    assert b[3] == -np.inf
    np.testing.assert_allclose(a[keep], b[keep], rtol=1e-5, atol=2e-3)
    with pytest.raises(ValueError):
        build_lnprob_batched(model, spec, grid.ints, grid.yerrs, lnprior,
                             use_pallas=True)


def test_sampler_with_batched_lnprob(hc5n_problem, hc5n_datagrid):
    from cha1_mcmc_tpu.sampler import run_ensemble

    model, spec, lnprior = (hc5n_problem["model"], hc5n_problem["spec"],
                            hc5n_problem["lnprior"])
    grid = hc5n_datagrid
    batched = build_lnprob_batched(model, spec, grid.ints, grid.yerrs, lnprior)
    rng = np.random.default_rng(0)
    pos0 = jnp.asarray(np.array([3.24e12, 7.5, 4.11, 0.78]) * (
        1 + 0.01 * rng.standard_normal((16, 4))), jnp.float32)
    lnp0 = batched(pos0)
    chain, lnps, acc, _ = run_ensemble(batched, pos0, lnp0,
                                       jax.random.PRNGKey(0), nsteps=40,
                                       batched=True)
    assert np.isfinite(np.asarray(lnps)).all()
    assert np.asarray(chain).shape == (40, 16, 4)


@pytest.mark.parametrize("W,L,C", [(12, 700, 300), (8, 512, 128), (3, 50, 700)])
def test_opacity_gather_matches_dense(W, L, C):
    """Channel-major gather path (pure jnp) vs the dense reference,
    including the active-line subset bookkeeping."""
    center = 4.10
    vel, taus, vlsr, dV = _random_problem(W, L, C)
    expected = _dense_reference(vel, taus, vlsr, dV, center)
    line_table, vel_t, active = build_opacity_gather(vel, center, dv_max=1.5)
    assert active.size <= L
    out = opacity_gather(jnp.asarray(taus[:, active]), jnp.asarray(vlsr),
                         jnp.asarray(dV), jnp.asarray(line_table),
                         jnp.asarray(vel_t), mask_center=center)
    np.testing.assert_allclose(np.asarray(out), expected, rtol=2e-4,
                               atol=1e-6 * max(1.0, expected.max()))


def test_opacity_gather_window_semantics():
    """The per-walker window select stays exact: a line just outside
    10*dV_w for one walker but inside 10*dv_max must not contribute for
    that walker (same regression family as the unmasked-kernel test)."""
    center = 4.10
    vel, taus, vlsr, dV = _random_problem(6, 120, 80, seed=3)
    dV = np.full_like(dV, 0.5)
    dV[0] = 1.4  # walker 0 sees a much wider window than the others
    expected = _dense_reference(vel, taus, vlsr, dV, center)
    line_table, vel_t, active = build_opacity_gather(vel, center, dv_max=1.5)
    out = opacity_gather(jnp.asarray(taus[:, active]), jnp.asarray(vlsr),
                         jnp.asarray(dV), jnp.asarray(line_table),
                         jnp.asarray(vel_t), mask_center=center)
    np.testing.assert_allclose(np.asarray(out), expected, rtol=2e-4,
                               atol=1e-7)


@pytest.mark.parametrize("W,L,C", [(12, 700, 300), (8, 512, 128)])
def test_opacity_gather_split_matches_dense(W, L, C):
    """Two-class split gather vs the dense reference and vs the plain
    gather (light channels bitwise, heavy channels f32-reassociated)."""
    center = 4.10
    vel, taus, vlsr, dV = _random_problem(W, L, C)
    expected = _dense_reference(vel, taus, vlsr, dV, center)
    split = build_opacity_gather_split(vel, center, dv_max=1.5,
                                       min_saving=0.0)
    assert split is not None
    t1, v1, t2, v2, heavy, active = split
    onehot = heavy_scatter_onehot(heavy, C)
    out = opacity_gather_split(
        jnp.asarray(taus[:, active]), jnp.asarray(vlsr), jnp.asarray(dV),
        jnp.asarray(t1), jnp.asarray(v1), jnp.asarray(t2), jnp.asarray(v2),
        jnp.asarray(onehot), mask_center=center)
    np.testing.assert_allclose(np.asarray(out), expected, rtol=2e-4,
                               atol=1e-6 * max(1.0, expected.max()))

    # same active subset and near-bitwise agreement with the plain gather
    line_table, vel_t, active_p = build_opacity_gather(vel, center,
                                                       dv_max=1.5)
    np.testing.assert_array_equal(active, active_p)
    plain = opacity_gather(jnp.asarray(taus[:, active]), jnp.asarray(vlsr),
                           jnp.asarray(dV), jnp.asarray(line_table),
                           jnp.asarray(vel_t), mask_center=center)
    counts = (np.abs(vel - center) < 15.0).sum(axis=0)
    light = counts <= t1.shape[0]
    np.testing.assert_array_equal(np.asarray(out)[:, light],
                                  np.asarray(plain)[:, light])
    np.testing.assert_allclose(np.asarray(out), np.asarray(plain),
                               rtol=1e-5, atol=1e-7)


def test_opacity_gather_split_declines_flat_counts():
    """Uniform per-channel line counts -> no saving -> builder returns
    None and build_lnprob_batched stays on the rectangular table."""
    # every channel covered by exactly the same number of lines
    vel = np.full((4, 64), 4.10, np.float32)
    assert build_opacity_gather_split(vel, 4.10, dv_max=1.5) is None


def test_batched_lnprob_gather_split_matches_plain(hc5n_problem,
                                                   hc5n_datagrid):
    """build_lnprob_batched auto-upgrades the gather path to the split
    tables when worthwhile; on HC5N (skewed hfs cluster counts) the two
    formulations must agree to f32 reassociation tolerance."""
    from cha1_mcmc_tpu.inference.likelihood import (batched_model_gather,
                                                    batched_model_gather_split)

    model, spec, lnprior = (hc5n_problem["model"], hc5n_problem["spec"],
                            hc5n_problem["lnprior"])
    grid = hc5n_datagrid
    split = build_opacity_gather_split(np.asarray(model.vel_grid),
                                       model.mask_center, dv_max=1.5,
                                       min_saving=0.0)
    if split is None:
        pytest.skip("HC5N window structure has no split advantage")
    t1, v1, t2, v2, heavy, active = split
    onehot = heavy_scatter_onehot(heavy, model.n_channels)
    lines = tuple(jnp.asarray(np.asarray(arr)[active])
                  for arr in (model.line_freq, model.line_elower,
                              model.line_aij, model.line_gup,
                              model.line_glow))
    g_split = (jnp.asarray(t1), jnp.asarray(v1, model.dtype),
               jnp.asarray(t2), jnp.asarray(v2, model.dtype),
               jnp.asarray(onehot, model.dtype))
    lt, vt, active_p = build_opacity_gather(np.asarray(model.vel_grid),
                                            model.mask_center, dv_max=1.5)
    np.testing.assert_array_equal(active, active_p)

    rng = np.random.default_rng(1)
    thetas = jnp.asarray(np.array([3.24e12, 7.5, 4.11, 0.78]) * (
        1 + 0.02 * rng.standard_normal((8, 4))), jnp.float32)
    a = batched_model_gather_split(
        *lines, model.q_model, model.grid_freq, model.mask_center,
        model.dish_size, model.Tbg, model.dtype, spec, thetas, g_split)
    b = batched_model_gather(
        *lines, model.q_model, model.grid_freq, model.mask_center,
        model.dish_size, model.Tbg, model.dtype, spec, thetas,
        jnp.asarray(lt), jnp.asarray(vt, model.dtype))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-8)
