"""Smoke run of the spectral-line fit on an NVIDIA GPU.

Drives the main path once through the entry points a user calls
(FitConfig / SpectralFit, build_lnprob_batched, EnsembleSampler) on inputs
generated from a seed (catalogs/synthetic.py), and checks every result
against the float64 host oracle (models/forward.py:forward_host):

  1. card identity (nvidia-smi name and power limit, jax.devices());
  2. flagship fit: HC5N, 128 walkers x 2000 steps, MLE Ncol init; chain
     shape, finiteness, acceptance, recovery of the injected truth, and a
     bitwise-identical same-seed rerun;
  3. flagship lnprob parity: the fit's f32 lnprob at 128 positions around
     the truth against the f64 host evaluation;
  4. dense lnprob: 35,460 lines x 2,048 channels through the sparse gather
     (the automatic choice for such a model), 8 walkers against the f64
     host evaluation, then 200 steps of the batched sampler;
  5. timings (us per ensemble step, ms per dense lnprob, compile seconds)
     beside the card's name and power limit.

    python chip_smoke.py               # one GPU, phases 1-5
    python chip_smoke.py --four-cards  # four GPUs: the mesh path only

--four-cards runs the line-sharded flagship fit (FitConfig n_devices=4,
n_line_shards=2), the line-sharded flagship lnprob against the
single-device one, and the dense lnprob over 4 line shards against the
single-device one. The last stdout line is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}; it is printed only
when every phase passed. Without a GPU the script exits non-zero before
any phase runs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(REPO, "results", "chip_smoke")

# Bounds of the checks, argued in PERF.md: f32 lnprob against the f64
# oracle, relative to max(1, |lnprob|); acceptance band of a healthy
# stretch-move ensemble; truth recovery in posterior standard deviations.
LNPROB_RTOL = 1e-5
ACCEPTANCE = (0.15, 0.6)
RECOVERY_SIGMA = 3.0



def card_identity() -> str:
    """`name, power.limit` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def _truth_vector(truth: dict) -> np.ndarray:
    return np.array([truth["Ncol"], truth["Tex"], truth["vlsr"], truth["dV"]])


def _walkers_near(truth: dict, n: int, seed: int) -> np.ndarray:
    """n float32-representable positions, 1% scatter around the truth."""
    rng = np.random.default_rng(seed)
    thetas = _truth_vector(truth) * (1 + 0.01 * rng.standard_normal((n, 4)))
    return thetas.astype(np.float32).astype(np.float64)


def _host_lnprior(lnprior, thetas: np.ndarray) -> np.ndarray:
    """The prior in float64 on the host CPU device."""
    import jax

    with jax.enable_x64(), jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(jax.vmap(lnprior)(np.asarray(thetas, np.float64)))


def _host_lnprob(lines, q_model, freqs, ints, yerrs, lnprior, thetas, *,
                 center, dish_size, source_size, Tbg) -> np.ndarray:
    """f64 oracle: forward_host + chi^2 (reference inference.py:157-166)
    + the prior, per theta."""
    from cha1_mcmc_tpu.models.forward import forward_host

    y = np.asarray(ints, np.float64)
    inv_sigma2 = 1.0 / np.asarray(yerrs, np.float64) ** 2
    out = []
    for Ncol, Tex, vlsr, dV in thetas:
        m = forward_host(lines, q_model, freqs, vel_offset=center,
                         mask_center=center, dish_size=dish_size, Tbg=Tbg,
                         source_size=source_size, Ncol=Ncol, Tex=Tex,
                         vlsr=vlsr, dV=dV)
        out.append(-0.5 * np.sum((y - m) ** 2 * inv_sigma2
                                 - np.log(inv_sigma2)))
    return np.asarray(out) + _host_lnprior(lnprior, thetas)


def _rel_err(device, host) -> float:
    device, host = np.asarray(device, np.float64), np.asarray(host)
    if not (np.isfinite(device).all() and np.isfinite(host).all()):
        raise AssertionError("non-finite lnprob in the parity check")
    return float(np.max(np.abs(device - host) / np.maximum(1.0, np.abs(host))))


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _time_steps(lnprob, pos, nsteps: int, batched: bool, reps: int = 3):
    """(compile seconds, steady us per ensemble step) of run_ensemble."""
    import jax
    import jax.numpy as jnp

    from cha1_mcmc_tpu.sampler import run_ensemble

    pos = jnp.asarray(pos, jnp.float32)
    lnp = lnprob(pos) if batched else jax.vmap(lnprob)(pos)
    key = jax.random.PRNGKey(11)
    t0 = time.perf_counter()
    compiled = run_ensemble.lower(lnprob, pos, lnp, key, nsteps=nsteps,
                                  batched=batched).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(pos, lnp, key))
    best = float("inf")
    for rep in range(reps):
        k = jax.random.fold_in(key, rep)
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(pos, lnp, k))
        best = min(best, time.perf_counter() - t0)
    return compile_s, 1e6 * best / nsteps


def _time_calls(fn, x, reps: int = 10):
    """(first-call seconds incl. compile, steady ms per call)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(x))
    first = time.perf_counter() - t0
    best = float("inf")
    for rep in range(reps):
        xr = x * (1.0 + 1e-7 * (rep + 1))
        t0 = time.perf_counter()
        jax.block_until_ready(fn(xr))
        best = min(best, time.perf_counter() - t0)
    return first, 1e3 * best


# -- phases -----------------------------------------------------------------

def phase_flagship_fit(workdir: str, *, nwalkers: int = 128,
                       nruns: int = 2000, checkpoint_every: int = 500,
                       seed: int = 0, n_devices: int | None = None,
                       n_line_shards: int = 1, log=None) -> dict:
    """The flagship fit through SpectralFit, run twice with one seed."""
    from cha1_mcmc_tpu import FitConfig, SpectralFit
    from cha1_mcmc_tpu.catalogs.synthetic import HC5N_TRUTH, write_hc5n_inputs

    cat_folder, data_path = write_hc5n_inputs(
        os.path.join(workdir, "inputs"), seed=seed)

    def run(tag):
        cfg = FitConfig(mol_name="hc5n_hfs", nwalkers=nwalkers, nruns=nruns,
                        checkpoint_every=checkpoint_every, MLE_for_Ncol=True,
                        cat_folder=cat_folder, data_path=data_path,
                        fit_folder=os.path.join(workdir, tag), seed=seed,
                        n_devices=n_devices, n_line_shards=n_line_shards)
        fit = SpectralFit(cfg)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log or sys.stdout):
            chain = fit.run()
        return fit, chain, time.perf_counter() - t0

    fit, chain, wall = run("fit_a")
    _, chain_b, wall_b = run("fit_b")
    _check(chain.shape == (nwalkers, nruns, 4), f"chain shape {chain.shape}")
    _check(bool(np.isfinite(chain).all()), "non-finite chain")
    acc = fit.sampler.acceptance_fraction
    _check(ACCEPTANCE[0] < acc < ACCEPTANCE[1], f"acceptance {acc:.3f}")
    post = chain[:, nruns // 5:, :].reshape(-1, 4)
    med, sd = np.median(post, axis=0), post.std(axis=0)
    z = np.abs(med - _truth_vector(HC5N_TRUTH)) / sd
    _check(bool((z[1:] < RECOVERY_SIGMA).all()),
           f"Tex/vlsr/dV not recovered: |median - truth| / sd = {z[1:]}")
    _check(np.array_equal(chain, chain_b), "same-seed rerun differs")
    return dict(fit=fit, wall_s=wall, rerun_wall_s=wall_b, acceptance=acc,
                z_tex_vlsr_dv=[float(v) for v in z[1:]])


def _flagship_parts(fit):
    """(model, lnprior, grid, host lines) of a finished flagship fit."""
    from cha1_mcmc_tpu.inference import single_component_lnprior
    from cha1_mcmc_tpu.models.forward import catalog_lines
    from cha1_mcmc_tpu.reduce.datagrid import load_datagrid

    cfg = fit.config
    grid = load_datagrid(cfg.datagrid_path)
    lnprior = single_component_lnprior(
        fit.spec, cfg.bounds, np.asarray(cfg.template_means),
        np.asarray(cfg.template_stds))
    lines = catalog_lines(fit.catalog, grid.covered_trans, cfg.lower_limit,
                          cfg.upper_limit)
    return fit.build_model(grid), lnprior, grid, lines


def phase_flagship_parity(fit, *, nwalkers: int = 128, seed: int = 1) -> dict:
    """The fit's own f32 lnprob (the function its sampler ran) at
    `nwalkers` positions around the truth, against the f64 oracle."""
    import jax

    from cha1_mcmc_tpu.catalogs.synthetic import HC5N_TRUTH

    model, lnprior, grid, lines = _flagship_parts(fit)
    cfg = fit.config
    thetas = _walkers_near(HC5N_TRUTH, nwalkers, seed)
    device = np.asarray(jax.jit(jax.vmap(fit.sampler.lnprob_fn))(
        thetas.astype(np.float32)))
    host = _host_lnprob(lines, model.q_model, grid.freqs, grid.ints,
                        grid.yerrs, lnprior, thetas,
                        center=cfg.aligned_velocity, dish_size=cfg.dish_size,
                        source_size=cfg.fixed_source_size, Tbg=model.Tbg)
    rel = _rel_err(device, host)
    _check(rel <= LNPROB_RTOL, f"flagship lnprob rel err {rel:.3e}")
    compile_s, us_step = _time_steps(fit.sampler.lnprob_fn, thetas,
                                     nsteps=2000, batched=False)
    return dict(rel_err=rel, lnprob_median=float(np.median(host)),
                compile_s=compile_s, us_per_step=us_step,
                walker_steps_per_s=nwalkers * 1e6 / us_step)


def phase_dense(*, n_lines: int = 35_460, n_channels: int = 2048,
                nwalkers: int = 128, n_check: int = 8, n_steps: int = 200,
                seed: int = 0) -> dict:
    """Dense batched lnprob through the automatic sparse path, checked
    against the f64 oracle, then `n_steps` of the batched sampler."""
    import jax

    from cha1_mcmc_tpu.catalogs.synthetic import (DENSE_BOUNDS, DENSE_TRUTH,
                                                  dense_problem)
    from cha1_mcmc_tpu.inference import build_lnprob_batched
    from cha1_mcmc_tpu.pipeline.fit import dense_catalog
    from cha1_mcmc_tpu.sampler import EnsembleSampler

    p = dense_problem(n_lines=n_lines, n_channels=n_channels, seed=seed)
    model = p["model"]
    _check(dense_catalog(model), "auto-rule did not pick the sparse path")
    lnprob = build_lnprob_batched(model, p["spec"], p["ints"], p["yerrs"],
                                  p["lnprior"], use_pallas=True,
                                  dv_max=DENSE_BOUNDS["dV"][1])
    thetas = _walkers_near(DENSE_TRUTH, nwalkers, seed + 2)
    fn = jax.jit(lnprob)
    first_s, ms_eval = _time_calls(fn, thetas.astype(np.float32))
    device = np.asarray(fn(thetas.astype(np.float32)))[:n_check]
    host = _host_lnprob(p["lines"], model.q_model, p["freqs"], p["ints"],
                        p["yerrs"], p["lnprior"], thetas[:n_check],
                        center=model.mask_center, dish_size=model.dish_size,
                        source_size=52.0, Tbg=model.Tbg)
    rel = _rel_err(device, host)
    _check(rel <= LNPROB_RTOL, f"dense lnprob rel err {rel:.3e}")
    sampler = EnsembleSampler(lnprob_fn=lnprob, nwalkers=nwalkers, ndim=4,
                              batched=True)
    pos, lnp = sampler.run_mcmc(thetas, n_steps, jax.random.PRNGKey(seed),
                                checkpoint_every=n_steps)
    _check(bool(np.isfinite(sampler.chain).all()), "non-finite dense chain")
    _check(bool(np.isfinite(lnp).all()), "non-finite dense lnprob")
    compile_s, us_step = _time_steps(lnprob, pos, nsteps=n_steps,
                                     batched=True)
    return dict(n_lines=model.n_lines, n_channels=model.n_channels,
                rel_err=rel, first_call_s=first_s, ms_per_lnprob=ms_eval,
                acceptance=sampler.acceptance_fraction,
                step_compile_s=compile_s, us_per_step=us_step)


def phase_mesh_lnprob(fit, *, n_devices: int = 4, n_line_shards: int = 2,
                      nwalkers: int = 128, nsteps: int = 500,
                      seed: int = 1) -> dict:
    """Line-sharded flagship lnprob against the single-device one, and the
    us per ensemble step of the mesh sampler beside the single device's."""
    import jax

    from cha1_mcmc_tpu.catalogs.synthetic import HC5N_TRUTH
    from cha1_mcmc_tpu.inference import build_lnprob
    from cha1_mcmc_tpu.parallel import (make_mesh, make_sharded_lnprob,
                                        make_sharded_runner)

    model, lnprior, grid, _ = _flagship_parts(fit)
    args = (model, fit.spec, grid.ints, grid.yerrs, lnprior)
    thetas = _walkers_near(HC5N_TRUTH, nwalkers, seed).astype(np.float32)
    lnprob = build_lnprob(*args)
    single = np.asarray(jax.jit(jax.vmap(lnprob))(thetas))
    mesh = make_mesh(n_devices // n_line_shards, n_line_shards)
    sharded = np.asarray(make_sharded_lnprob(*args, mesh)(thetas))
    rel = _rel_err(sharded, single)
    _check(rel <= LNPROB_RTOL, f"sharded flagship lnprob rel err {rel:.3e}")

    runner = make_sharded_runner(*args, mesh, nsteps)
    key = jax.random.PRNGKey(11)
    t0 = time.perf_counter()
    jax.block_until_ready(runner(thetas, key))
    mesh_first_s = time.perf_counter() - t0
    best = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(runner(thetas, jax.random.fold_in(key, rep)))
        best = min(best, time.perf_counter() - t0)
    _, single_us = _time_steps(lnprob, thetas, nsteps=nsteps, batched=False)
    return dict(rel_err=rel, mesh_first_call_s=mesh_first_s,
                mesh_us_per_step=1e6 * best / nsteps,
                single_us_per_step=single_us)


def phase_mesh_dense(*, n_shards: int = 4, n_lines: int = 35_460,
                     n_channels: int = 2048, nwalkers: int = 128,
                     seed: int = 0) -> dict:
    """Dense lnprob with the lines split over `n_shards` devices (per-shard
    gather + one psum) against the single-device gather."""
    import jax

    from cha1_mcmc_tpu.catalogs.synthetic import (DENSE_BOUNDS, DENSE_TRUTH,
                                                  dense_problem)
    from cha1_mcmc_tpu.inference import build_lnprob_batched
    from cha1_mcmc_tpu.parallel import make_mesh, make_sharded_lnprob

    p = dense_problem(n_lines=n_lines, n_channels=n_channels, seed=seed)
    args = (p["model"], p["spec"], p["ints"], p["yerrs"], p["lnprior"])
    dv_max = DENSE_BOUNDS["dV"][1]
    thetas = _walkers_near(DENSE_TRUTH, nwalkers, seed + 2).astype(np.float32)
    single_fn = jax.jit(build_lnprob_batched(*args, use_pallas=True,
                                             dv_max=dv_max))
    sharded_fn = make_sharded_lnprob(*args, make_mesh(1, n_shards),
                                     use_pallas=True, dv_max=dv_max)
    _, single_ms = _time_calls(single_fn, thetas)
    _, sharded_ms = _time_calls(sharded_fn, thetas)
    rel = _rel_err(sharded_fn(thetas), single_fn(thetas))
    _check(rel <= LNPROB_RTOL, f"sharded dense lnprob rel err {rel:.3e}")
    return dict(rel_err=rel, single_ms_per_lnprob=single_ms,
                sharded_ms_per_lnprob=sharded_ms)


# -- driver -----------------------------------------------------------------

def _run_phase(name: str, fn, results: dict) -> bool:
    """Run one phase; a failure is reported with its traceback and the
    remaining phases still run (the script then exits non-zero)."""
    t0 = time.perf_counter()
    try:
        out = fn() or {}
    except Exception:  # reported below; the exit code carries it
        print(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s")
        traceback.print_exc(file=sys.stdout)
        results[name] = None
        return False
    out.pop("fit", None)
    results[name] = out
    print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
          f"{json.dumps(out)}", flush=True)
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-GPU mesh path and its checks")
    args = parser.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend is "
              f"'{jax.default_backend()}'); nothing was run.",
              file=sys.stderr)
        return 1
    devices = jax.devices()
    n_cards = 4 if args.four_cards else 1
    if len(devices) < n_cards:
        print(f"chip_smoke: {n_cards} GPUs needed, {len(devices)} found.",
              file=sys.stderr)
        return 1
    card = card_identity()
    print(f"card: {card}")
    print(f"jax devices: {devices}", flush=True)

    os.makedirs(WORKDIR, exist_ok=True)
    results, state = {}, {}
    ok = True
    with open(os.path.join(WORKDIR, "fit_log.txt"), "w") as log:
        def fit_phase(**kw):
            out = phase_flagship_fit(WORKDIR, log=log, **kw)
            state["fit"] = out["fit"]
            return out

        if args.four_cards:
            ok &= _run_phase("mesh_fit", lambda: fit_phase(
                n_devices=4, n_line_shards=2), results)
            if "fit" in state:
                ok &= _run_phase("mesh_flagship_lnprob", lambda:
                                 phase_mesh_lnprob(state["fit"]), results)
            else:
                ok = False
            ok &= _run_phase("mesh_dense_lnprob", phase_mesh_dense, results)
        else:
            ok &= _run_phase("flagship_fit", fit_phase, results)
            if "fit" in state:
                ok &= _run_phase("flagship_lnprob", lambda:
                                 phase_flagship_parity(state["fit"]), results)
            else:
                ok = False
            ok &= _run_phase("dense", phase_dense, results)
    if not ok:
        print("chip_smoke: a phase failed (see above).")
        return 1
    timings = {name: {k: v for k, v in (out or {}).items()
                      if k.endswith(("_s", "_ms", "per_step", "_per_lnprob",
                                     "per_s"))}
               for name, out in results.items()}
    print(f"timings [{card}]: {json.dumps(timings)}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
