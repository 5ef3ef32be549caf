"""Benchmark: HC5N walker-steps/sec on the accelerator vs the reference CPU path.

The LAST line on stdout is the full artifact, ONE JSON line:
  {"metric": "walker_steps_per_sec_hc5n", "value": <flagship rate>,
   "unit": "walker_steps/s", "vs_baseline": <rate / reference CPU rate>,
   "device": {"platform", "kind", "count"}, ...}

Each section additionally streams its own one-line JSON record
({"bench_section": <name>, ...}) to stdout the moment it completes, so an
external kill still leaves every completed section's numbers in the
captured output tail. Reduction/pipeline chatter goes to a log file
(CHA1_BENCH_LOG, default results/bench_chatter.log), never to stdout.

Every device section needs an accelerator: on a CPU-only JAX backend it
fails (ok: false) instead of timing the CPU under a device metric's name.

One walker-step == one lnprob evaluation (the reference performs exactly one
per walker per emcee step, reference inference.py:456-463).

Inputs: the flagship and dense sections run on seeded synthetic inputs
(catalogs/synthetic.py). The baseline, GOTHAM and dense full-fit sections
need the reference data tree and report an error without it.

Baseline methodology (the reference publishes no numbers): the reference's
own per-eval path is executed in place — its MolSim catalog math (reference
spectral_simulator/classes.py:294-397) plus a vectorized NumPy stand-in for
its Numba model kernel — then scaled by the CPU core count to credit the
reference's multiprocessing.Pool walker fan-out with perfect scaling. Both
choices are generous to the baseline, making vs_baseline conservative.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

REFERENCE_ROOT = "/root/reference"

NWALKERS = 128
FLAGSHIP_STEPS = 2000
BASELINE_SECONDS = 3.0


# While _chatter() has stdout redirected (redirect_stdout rebinds
# sys.stdout PROCESS-WIDE, all threads), _EMIT holds the pre-redirect
# stream so section/artifact emissions still reach the real stdout even
# when the watchdog fires mid-section.
_EMIT = None


def _emit_line(text: str) -> None:
    out = _EMIT or sys.stdout
    out.write(text + "\n")
    out.flush()


@contextlib.contextmanager
def _chatter():
    """Route section chatter (reduction logs, fit progress) to a log file,
    so the recorded output tail holds only results."""
    global _EMIT
    path = os.environ.get("CHA1_BENCH_LOG",
                          os.path.join(REPO, "results", "bench_chatter.log"))
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fh = open(path, "a")
    except OSError:
        fh = open(os.devnull, "w")
    _EMIT = sys.stdout
    try:
        with fh, contextlib.redirect_stdout(fh), \
                contextlib.redirect_stderr(fh):
            yield
    finally:
        _EMIT = None


def device_info() -> dict:
    """The device every timed number of this run belongs to."""
    import jax

    devices = jax.devices()
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def _require_accelerator() -> None:
    import jax

    if jax.default_backend() == "cpu":
        raise RuntimeError("no accelerator: JAX backend is 'cpu'")


def _problem():
    from __graft_entry__ import _flagship_problem

    with _chatter():
        return _flagship_problem()


def _slope_timed(run, n1: int, n2: int, reps: int = 6):
    """Steady-state per-unit time via two run lengths.

    Timing at two lengths and taking (t(n2) - t(n1)) / (n2 - n1) cancels
    the fixed per-call cost (dispatch, argument transfer, host sync); the
    best of `reps` interleaved samples per length is kept, since
    interference only ever adds time.

    `run(n, tag)` must execute one measurement of length n (inputs varied
    by `tag`) and return a value to block on. Returns (per_unit_seconds,
    fixed_ms). A non-positive slope, or one below 1% of the long run's
    naive per-unit time (the longer run cost no more than the shorter),
    is a collapsed measurement and raises, marking the section not ok.
    """
    import jax

    jax.block_until_ready(run(n1, 0))   # compile + warm, both lengths
    jax.block_until_ready(run(n2, 0))

    t1 = t2 = float("inf")
    for rep in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(n1, 2 * rep + 1))
        t1 = min(t1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        jax.block_until_ready(run(n2, 2 * rep + 2))
        t2 = min(t2, time.perf_counter() - t0)

    slope = (t2 - t1) / (n2 - n1)
    if slope <= 0.01 * t2 / n2:
        raise RuntimeError(f"collapsed slope {slope:.3e} s/unit "
                           f"(t({n1})={t1:.4f} s, t({n2})={t2:.4f} s)")
    return slope, (t1 - n1 * slope) * 1e3


def bench_flagship() -> dict:
    """Headline: walker-steps/s of the general lax.scan sampler at the
    flagship size (HC5N, 9 lines x ~560 channels, 128 walkers) — what
    SpectralFit runs."""
    import jax
    import jax.numpy as jnp

    from cha1_mcmc_tpu.inference import build_lnprob
    from cha1_mcmc_tpu.sampler import run_ensemble

    _require_accelerator()
    model, spec, lnprior, ints, yerrs = _problem()
    lnprob = build_lnprob(model, spec, ints, yerrs, lnprior)

    rng = np.random.default_rng(0)
    pos0 = jnp.asarray(np.asarray(
        np.array([3.24e12, 7.5, 4.11, 0.78])
        * (1 + 0.01 * rng.standard_normal((NWALKERS, 4))), dtype=np.float32))
    lnp0 = jax.vmap(lnprob)(pos0)
    key = jax.random.PRNGKey(0)
    chain, lnps, acc, (pos, lnp) = run_ensemble(lnprob, pos0, lnp0, key,
                                                nsteps=FLAGSHIP_STEPS)
    jax.block_until_ready(chain)
    slope, fixed_ms = _slope_timed(
        lambda n, tag: run_ensemble(lnprob, pos, lnp,
                                    jax.random.fold_in(key, tag),
                                    nsteps=n)[0],
        FLAGSHIP_STEPS, 4 * FLAGSHIP_STEPS)
    return {
        "rate": NWALKERS / slope,
        "us_per_step": slope * 1e6,
        "fixed_ms_per_call": fixed_ms,
        "steps": FLAGSHIP_STEPS,
        "nwalkers": NWALKERS,
        "n_lines": model.n_lines,
        "n_channels": model.n_channels,
        "acceptance": float(np.asarray(acc).sum()) / (FLAGSHIP_STEPS * NWALKERS),
        "device": device_info(),
    }


LARGE_WALKERS = 8192
LARGE_STEPS = 500


def bench_large() -> dict:
    """Saturation throughput: the same HC5N problem at 8192 walkers — the
    regime where the device's throughput, not per-step latency, sets the
    rate (many independent chains / cross-chain R-hat)."""
    import jax
    import jax.numpy as jnp

    from cha1_mcmc_tpu.inference import build_lnprob
    from cha1_mcmc_tpu.sampler import run_ensemble

    _require_accelerator()
    model, spec, lnprior, ints, yerrs = _problem()
    lnprob = build_lnprob(model, spec, ints, yerrs, lnprior)
    rng = np.random.default_rng(3)
    pos0 = jnp.asarray(
        np.array([3.24e12, 7.5, 4.11, 0.78])
        * (1 + 0.01 * rng.standard_normal((LARGE_WALKERS, 4))), jnp.float32)
    lnp0 = jax.vmap(lnprob)(pos0)
    key = jax.random.PRNGKey(3)
    chain, lnps, acc, (pos, lnp) = run_ensemble(
        lnprob, pos0, lnp0, key, nsteps=LARGE_STEPS)
    jax.block_until_ready(chain)
    slope, _ = _slope_timed(
        lambda n, tag: run_ensemble(lnprob, pos, lnp,
                                    jax.random.fold_in(key, tag),
                                    nsteps=n)[0],
        LARGE_STEPS, 4 * LARGE_STEPS)
    return {"nwalkers": LARGE_WALKERS,
            "walker_steps_per_sec": LARGE_WALKERS / slope,
            "device": device_info()}


MULTIFIT_STEPS = 512
GOTHAM_DATA = os.path.join(REFERENCE_ROOT, "data", "GOTHAM",
                           "hc9n_hfs_chunks.npy")


def bench_multifit() -> dict:
    """Widest model family: the 14-dim 4-component GOTHAM TMC-1 fit
    (reference scripts/MCMC/TMC1_four_component.py) on the hc9n_hfs
    datagrid — 4 velocity components over 66 covered transitions x 1133
    channels, ordered-velocity prior, through the batched gather path the
    pipeline runs. Needs the reference data tree."""
    import tempfile

    import jax
    import jax.numpy as jnp

    from cha1_mcmc_tpu import MultiFitConfig, MultiComponentFit
    from cha1_mcmc_tpu.inference import (build_lnprob_batched,
                                         ordered_velocity_lnprior)
    from cha1_mcmc_tpu.sampler import run_ensemble

    _require_accelerator()
    if not os.path.exists(GOTHAM_DATA):
        raise FileNotFoundError(f"{GOTHAM_DATA} (reference data tree)")
    with tempfile.TemporaryDirectory() as tmp:
        cfg = MultiFitConfig(
            mol_name="hc9n_hfs", template_run=True,
            cat_folder=os.path.join(REFERENCE_ROOT, "catalog"),
            data_path=GOTHAM_DATA, fit_folder=tmp, nwalkers=NWALKERS)
        fit = MultiComponentFit(cfg)
        with _chatter():  # reduction chatter must not reach stdout/stderr
            grid = fit.init_setup()
            model = fit.build_model(grid)
    lnprior = ordered_velocity_lnprior(fit.spec,
                                       np.asarray(cfg.template_means),
                                       np.asarray(cfg.template_stds))
    lnprob_b = build_lnprob_batched(model, fit.spec, grid.ints, grid.yerrs,
                                    lnprior, use_pallas=True,
                                    dv_max=cfg.dv_bound)
    rng = np.random.default_rng(0)
    pos0 = jnp.asarray(
        np.asarray(cfg.template_means)
        + np.asarray(cfg.perturbation) * rng.standard_normal((NWALKERS, cfg.ndim)),
        jnp.float32)
    lnp0 = lnprob_b(pos0)
    key = jax.random.PRNGKey(0)
    chain, lnps, acc, (pos, lnp) = run_ensemble(
        lnprob_b, pos0, lnp0, key, nsteps=MULTIFIT_STEPS, batched=True)
    jax.block_until_ready(chain)
    slope, _ = _slope_timed(
        lambda n, tag: run_ensemble(lnprob_b, pos, jnp.asarray(lnp),
                                    jax.random.fold_in(key, tag), nsteps=n,
                                    batched=True)[0],
        MULTIFIT_STEPS, 4 * MULTIFIT_STEPS)
    return {
        "ndim": cfg.ndim,
        "ncomp": cfg.ncomp,
        "n_covered": int(grid.covered_trans.size),
        "n_channels": int(grid.freqs.size),
        "nwalkers": NWALKERS,
        "walker_steps_per_sec": NWALKERS / slope,
        "us_per_step": slope * 1e6,
        "device": device_info(),
    }


DENSE_EVALS = 30


def bench_dense() -> dict:
    """Dense-catalog stress case (SURVEY §6): the batched lnprob over a
    seeded 35,460-line x 2,048-channel model (catalogs/synthetic.py:
    dense_problem, the shape of the reference's 1-cyanonaphthalene
    catalog), 128 walkers, through the channel-major gather path the
    pipeline auto-selects, plus a multi-step chain through it. (The dense
    einsum's (W, L, C) intermediate is ~37 GB here; XLA's GPU compile of
    it did not finish within a 1000 s section deadline.)"""
    import jax
    import jax.numpy as jnp

    from cha1_mcmc_tpu.catalogs.synthetic import (DENSE_BOUNDS, DENSE_TRUTH,
                                                  dense_problem)
    from cha1_mcmc_tpu.inference.likelihood import build_lnprob_batched
    from cha1_mcmc_tpu.models.opacity import (build_opacity_gather,
                                              build_opacity_gather_split)
    from cha1_mcmc_tpu.sampler import run_ensemble

    _require_accelerator()
    p = dense_problem()
    model, spec, lnprior = p["model"], p["spec"], p["lnprior"]
    ints, yerrs = p["ints"], p["yerrs"]
    dv_max = DENSE_BOUNDS["dV"][1]
    center = model.mask_center
    truth = np.array([DENSE_TRUTH[k] for k in ("Ncol", "Tex", "vlsr", "dV")])
    rng = np.random.default_rng(2)
    thetas = jnp.asarray(
        truth * (1 + 0.01 * rng.standard_normal((NWALKERS, 4))), jnp.float32)

    lnprob_gather = build_lnprob_batched(
        model, spec, ints, yerrs, lnprior, use_pallas=True, dv_max=dv_max)

    def timed(fn):
        @functools.partial(jax.jit, static_argnames=("length",))
        def run(thetas, length):
            def body(carry, _):
                # Data dependence between iterations keeps XLA from hoisting
                # the evaluation out of the loop; sin() bounds the
                # perturbation to +-1e-6 so thetas stay inside the prior box.
                lnp = fn(thetas * (1.0 + 1e-6 * jnp.sin(carry)))
                return jnp.float32(jnp.mean(lnp)), ()

            carry, _ = jax.lax.scan(body, jnp.float32(0.0), None,
                                    length=length)
            return carry

        slope, _ = _slope_timed(
            lambda n, tag: run(thetas * (1.0 + 1e-9 * tag), length=n),
            DENSE_EVALS, 4 * DENSE_EVALS)
        return slope

    gather_s = timed(lnprob_gather)

    # Full-chain sampling on the dense catalog through the gather path —
    # the walker-steps/s a user of the dense-aromatic config gets.
    lnp0 = lnprob_gather(thetas)
    key = jax.random.PRNGKey(0)
    chain, _, acc, (pos, lnp) = run_ensemble(
        lnprob_gather, thetas, lnp0, key, nsteps=64, batched=True)
    jax.block_until_ready(chain)
    chain_slope, _ = _slope_timed(
        lambda n, tag: run_ensemble(lnprob_gather, pos, jnp.asarray(lnp),
                                    jax.random.fold_in(key, tag),
                                    nsteps=n, batched=True)[0], 64, 256)

    vel_grid = np.asarray(model.vel_grid)
    g_table, _, g_active = build_opacity_gather(vel_grid, center, dv_max)
    split = build_opacity_gather_split(vel_grid, center, dv_max)
    gather_split = None
    if split is not None:
        t1, _, t2, _, heavy, _ = split
        gather_split = {"M1": int(t1.shape[0]), "M2": int(t2.shape[0]),
                        "heavy_channels": int(heavy.size)}
    return {
        "n_lines": model.n_lines,
        "n_active_lines": int(g_active.size),
        "gather_table_M": int(g_table.shape[0]),
        "gather_split": gather_split,
        "n_channels": model.n_channels,
        "nwalkers": NWALKERS,
        "gather_ms_per_eval": gather_s * 1e3,
        "chain_walker_steps_per_sec": NWALKERS / chain_slope,
        "chain_us_per_step": chain_slope * 1e6,
        "device": device_info(),
    }


DENSE_GOLDEN = os.path.join(REPO, "tests", "golden", "dense_synth.npz")
DENSE_CAT = os.path.join(REFERENCE_ROOT, "catalog", "1-cyanonapthalene.cat")


def bench_dense_full_fit() -> dict:
    """Default-scale end-to-end dense aromatic fit: 128 walkers x 10,000
    steps through the real SpectralFit pipeline (MLE Ncol init, the
    auto-selected sparse gather path) on the committed reduced datagrid of
    the 1-cyanonaphthalene synthetic observation
    (tests/golden/dense_synth.npz, regenerable with
    `tools/dense_full_fit.py synth`). Needs the reference catalog."""
    from tools.dense_full_fit import run_fit_from_datagrid

    _require_accelerator()
    if not os.path.exists(DENSE_CAT):
        raise FileNotFoundError(f"{DENSE_CAT} (reference data tree)")
    with _chatter():  # fit progress chatter must not reach stdout/stderr
        stats = run_fit_from_datagrid(nruns=10_000, nwalkers=NWALKERS)
    return {
        "n_lines_covered": stats["n_lines_covered"],
        "n_channels": stats["n_channels"],
        "nwalkers": stats["nwalkers"],
        "nruns": stats["nruns"],
        "sampler": stats["sampler"],
        "wall_seconds": stats["wall_seconds"],
        "walker_steps_per_sec": stats["walker_steps_per_sec"],
        "acceptance": stats["acceptance"],
        "recovery_z_max": stats["recovery_z_max"],
        "ess_min": min(stats["ess"].values()),
        "tau_max": max(stats["tau"].values()),
        "device": device_info(),
    }


def _reference_lnprob_factory():
    """One reference-fidelity lnprob evaluation on the CPU (see module doc)."""
    if not os.path.isdir(REFERENCE_ROOT):
        raise RuntimeError("reference tree required for the baseline measurement")
    from tests import reference_oracle

    from cha1_mcmc_tpu.catalogs import load_catalog
    from cha1_mcmc_tpu.reduce.datagrid import reduce_spectrum

    means = np.array([3.4e10, 8.0, 4.3, 0.7575])
    stds = np.array([0.34e10, 3.0, 0.06, 0.22])
    classes, _, _ = reference_oracle.load_reference()
    mol_cat = classes.MolCat(
        "hc5n_hfs", os.path.join(REFERENCE_ROOT, "catalog", "hc5n_hfs.cat"))
    obs = classes.ObsParams("bench", dish_size=70, source_size=52.0)

    def predict(Ncol, Tex, dV):
        sim = classes.MolSim(
            "sim", mol_cat, obs, vlsr=[4.10], C=[Ncol], dV=[dV], T=[Tex],
            ll=[18000], ul=[25000], gauss=False)
        return np.array(sim.freq_sim), np.array(sim.tau_sim)

    catalog = load_catalog(os.path.join(REFERENCE_ROOT, "catalog", "hc5n_hfs.cat"))
    grid = reduce_spectrum(
        catalog, os.path.join(REFERENCE_ROOT, "data", "DSN", "cha_mms1_hc5n_example.npy"),
        ll=18000, ul=25000, aligned_velocity=4.10, dish_size=70,
        source_size=52.0, block_interlopers=True, verbose=False)
    covered = grid.covered_trans
    gfreq, gints, gyerr = grid.freqs, grid.ints, grid.yerrs
    inv_sigma2 = 1.0 / gyerr ** 2
    h, k, ckm, cm = 6.626e-34, 1.381e-23, 2.998e5, 2.998e8

    def make_model_numpy(freqs, taus, ss, vlsr, dV, Tex):
        # Vectorized equivalent of the reference's Numba accumulation kernel
        # (reference inference.py:44-61).
        vel = (freqs[:, None] - gfreq[None, :]) / freqs[:, None] * ckm + 4.10
        mask = np.abs(vel - 4.10) < dV * 10
        opac = (taus[:, None] * np.where(
            mask, np.exp(-0.5 * ((vel - vlsr) / (dV / 2.355)) ** 2), 0.0)).sum(0)
        x = h * gfreq * 1e6 / k
        J_T = x / (np.exp(x / Tex) - 1 + 1e-10)
        J_Tbg = x / (np.exp(x / 2.7) - 1 + 1e-10)
        beam = (cm / (gfreq * 1e6)) * 206265 * 1.22 / 70.0
        dil = ss ** 2 / (beam ** 2 + ss ** 2)
        return dil * (J_T - J_Tbg) * (1 - np.exp(-opac))

    def lnprob(theta):
        Ncol, Tex, vlsr, dV = theta
        if not (1e8 < Ncol < 1e14 and 3.5 < Tex < 12.0 and 3.0 < vlsr < 5.5
                and 0.4 < dV < 1.5):
            return -np.inf
        std_vlsr, std_dV = means[3] * 0.8, means[3] * 0.3
        lp = (np.log(1 / (np.sqrt(2 * np.pi) * stds[1])) - 0.5 * (Tex - means[1]) ** 2 / stds[1] ** 2
              + np.log(1 / (np.sqrt(2 * np.pi) * std_vlsr)) - 0.5 * (vlsr - means[2]) ** 2 / std_vlsr ** 2
              + np.log(1 / (np.sqrt(2 * np.pi) * std_dV)) - 0.5 * (dV - means[3]) ** 2 / std_dV ** 2)
        freqs, taus = predict(Ncol, Tex, dV)  # full reference catalog math
        freqs, taus = freqs[covered], taus[covered]
        model = make_model_numpy(freqs, taus, 52.0, vlsr, dV, Tex)
        ll = -0.5 * np.sum((gints - model) ** 2 * inv_sigma2 - np.log(inv_sigma2))
        return lp + ll

    return lnprob


def bench_baseline() -> dict:
    lnprob = _reference_lnprob_factory()
    rng = np.random.default_rng(1)
    thetas = np.array([3.24e12, 7.5, 4.11, 0.78]) * (
        1 + 0.01 * rng.standard_normal((4096, 4)))
    # Warmup + timed loop.
    lnprob(thetas[0])
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < BASELINE_SECONDS:
        lnprob(thetas[n % len(thetas)])
        n += 1
    dt = time.perf_counter() - t0
    cores = os.cpu_count() or 1
    single = n / dt
    return {
        "rate": single * cores,
        "single_core_rate": single,
        "cores": cores,
        "evals": n,
        "seconds": dt,
    }


# ---------------------------------------------------------------------------
# Harness: every section runs independently, recording {"ok": ..., "error":
# ...}; partial results persist to a sidecar file after each section; and a
# watchdog force-emits whatever has completed if the overall deadline passes
# mid-section. The process exits 0 with one JSON line on stdout.
# ---------------------------------------------------------------------------


def _assemble(results: dict) -> dict:
    """Build the one-line artifact from whatever sections completed."""
    flag = results.get("flagship", {})
    base = results.get("baseline", {})
    have_rate = flag.get("ok") and flag.get("rate") is not None
    have_base = base.get("ok") and base.get("rate")
    result = {
        "metric": "walker_steps_per_sec_hc5n",
        "value": flag["rate"] if have_rate else None,
        "unit": "walker_steps/s",
        "vs_baseline": (flag["rate"] / base["rate"]
                        if have_rate and have_base else None),
        "nwalkers": NWALKERS,
    }
    if have_base:
        result.update({
            "baseline_walker_steps_per_sec": base["rate"],
            "baseline_single_core": base["single_core_rate"],
            "baseline_cores": base["cores"],
        })
    else:
        result["baseline_error"] = base.get("error", "section did not run")
    if have_rate:
        result.update({
            "device": flag["device"],
            "flagship_acceptance": flag["acceptance"],
            "flagship_us_per_step": flag["us_per_step"],
        })
    else:
        result["flagship_error"] = flag.get("error", "section did not run")
    result["dense_35k_lines"] = results.get("dense")
    result["dense_full_fit"] = results.get("dense_full_fit")
    result["saturation_8192_walkers"] = results.get("large")
    result["gotham_14dim_multifit"] = results.get("gotham")
    return result


def _stream_section(name: str, entry: dict) -> None:
    """One JSON line per completed section, immediately — completed
    sections survive a hard kill of the process."""
    _emit_line(json.dumps({"bench_section": name, **entry}))


def run_sections(sections, deadline_s, partial_path) -> dict:
    """Run `(name, fn)` sections serially; each lands {"ok": ..., ...}
    regardless of the others and is streamed to stdout the moment it
    completes. Partial results persist to `partial_path` after every
    section, and a watchdog force-emits the full artifact if `deadline_s`
    expires mid-section."""
    import threading

    state = {"results": {}, "current": None, "done": False}
    lock = threading.Lock()

    def emit_and_exit():
        with lock:
            if state["done"]:
                return
            state["done"] = True
            results = dict(state["results"])
            if state["current"] is not None:
                results[state["current"]] = {
                    "ok": False,
                    "error": (f"watchdog: section '{state['current']}' still "
                              f"running at the {deadline_s:.0f}s deadline"),
                }
        out = _assemble(results)
        out["watchdog_fired"] = True
        _emit_line(json.dumps(out))
        os._exit(0)

    watchdog = threading.Timer(deadline_s, emit_and_exit)
    watchdog.daemon = True
    watchdog.start()

    for name, fn in sections:
        with lock:
            state["current"] = name
        t0 = time.perf_counter()
        try:
            values = fn()
            entry = {"ok": True, **(values or {})}
        except Exception as exc:  # recorded in the artifact; next section runs
            entry = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
        entry["seconds"] = time.perf_counter() - t0
        with lock:
            state["current"] = None
            state["results"][name] = entry
        _stream_section(name, entry)
        if partial_path:
            try:
                with open(partial_path, "w") as f:
                    json.dump(_assemble(state["results"]), f)
            except OSError:
                pass
    with lock:
        state["done"] = True
    watchdog.cancel()
    return state["results"]


def default_sections():
    # Cheap sections first, so a slow one cannot shadow them at the deadline.
    return [
        ("baseline", bench_baseline),
        ("flagship", bench_flagship),
        ("large", bench_large),
        ("gotham", bench_multifit),
        ("dense", bench_dense),
        ("dense_full_fit", bench_dense_full_fit),
    ]


def main(sections=None):
    from cha1_mcmc_tpu.utils import enable_compilation_cache

    t_start = time.perf_counter()
    enable_compilation_cache()
    deadline_s = float(os.environ.get("CHA1_BENCH_DEADLINE_S", "2700"))
    partial_path = os.environ.get(
        "CHA1_BENCH_PARTIAL", os.path.join(REPO, "results", "bench_partial.json"))
    if partial_path:
        os.makedirs(os.path.dirname(partial_path) or ".", exist_ok=True)
    section_budget = max(60.0, deadline_s - (time.perf_counter() - t_start))
    results = run_sections(sections or default_sections(), section_budget,
                           partial_path)
    out = _assemble(results)
    out["device"] = device_info()
    _emit_line(json.dumps(out))


if __name__ == "__main__":
    main()
