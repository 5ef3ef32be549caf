"""Device-trace breakdown of a steady sampler window on the GPU.

    python tools/trace_step.py [--out results/trace] [--steps 200]

Traces one steady window of `run_ensemble` for each of two cells — the
flagship (seeded HC5N, 9 lines x 564 channels, 128 walkers, vmapped
scalar lnprob: what SpectralFit runs) and the dense catalog (seeded
35,460 lines x 2,048 channels, 128 walkers, batched sparse gather) — and
reduces each jax.profiler trace (`reduce_trace`) to kernels launched per
ensemble step, device busy time per step, the device idle share of the
window, and the kernels that take the most device time. Prints one JSON
line per cell, after a line naming the card and its power limit; the
per-line trace summaries are written under --out. Exits non-zero without
a GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WINDOW = "steady_window"
# Lines of a device plane that JAX derives from the raw activity (the
# activity itself sits on per-stream lines).
DERIVED_LINES = ("XLA Modules", "XLA Ops", "Steps", "Framework Name Scope",
                 "Source code", "TensorFlow Ops", "Launch Stats")


def _union_ns(intervals) -> float:
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def reduce_trace(planes, nsteps: int, window: str = WINDOW) -> dict:
    """Reduce a trace to per-step device metrics.

    `planes` are jax.profiler.ProfileData planes (or anything with
    .name, .lines -> .name, .events -> .name/.start_ns/.duration_ns). The
    window is the host annotation named `window`; device activity is every
    event on a device plane's stream lines inside it. Kernels exclude
    memcpy/memset events, which are counted apart."""
    planes = list(planes)  # ProfileData yields its planes once
    win = None
    for plane in planes:
        if plane.name.startswith("/host"):
            for line in plane.lines:
                for ev in line.events:
                    if ev.name == window:
                        win = (ev.start_ns, ev.start_ns + ev.duration_ns)
    if win is None:
        raise ValueError(f"no host span named {window!r} in the trace")
    lines_out, busy, kernels = [], [], {}
    n_copies = 0
    for plane in planes:
        if not plane.name.startswith("/device"):
            continue
        for line in plane.lines:
            evs = [ev for ev in line.events
                   if win[0] <= ev.start_ns < win[1]]
            lines_out.append({"plane": plane.name, "line": line.name,
                              "events": len(evs),
                              "ns": float(sum(e.duration_ns for e in evs))})
            if line.name in DERIVED_LINES:
                continue
            for ev in evs:
                busy.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                if ev.name.lower().startswith(("memcpy", "memset")):
                    n_copies += 1
                    continue
                n, ns = kernels.get(ev.name, (0, 0.0))
                kernels[ev.name] = (n + 1, ns + ev.duration_ns)
    window_ns = win[1] - win[0]
    busy_ns = _union_ns(busy)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    return {
        "window_us_per_step": window_ns / nsteps / 1e3,
        "device_busy_us_per_step": busy_ns / nsteps / 1e3,
        "device_idle_share": 1.0 - busy_ns / window_ns if window_ns else None,
        "kernels_per_step": sum(n for n, _ in kernels.values()) / nsteps,
        "copies_per_step": n_copies / nsteps,
        "distinct_kernels": len(kernels),
        "top_kernels": [{"name": name[:120], "per_step": n / nsteps,
                         "us_per_step": ns / nsteps / 1e3}
                        for name, (n, ns) in top],
        "lines": lines_out,
    }


def trace_window(run, nsteps: int, trace_dir: str) -> dict:
    """Trace one call of `run()` (already compiled and warm) and reduce."""
    import jax
    from jax.profiler import ProfileData

    with jax.profiler.trace(trace_dir):
        with jax.profiler.TraceAnnotation(WINDOW):
            jax.block_until_ready(run())
    path = max(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                         recursive=True), key=os.path.getmtime)
    return reduce_trace(ProfileData.from_file(path).planes, nsteps)


def _cell(name, lnprob, pos, nsteps, batched, out_dir):
    import jax
    import jax.numpy as jnp

    from cha1_mcmc_tpu.sampler import run_ensemble

    pos = jnp.asarray(pos, jnp.float32)
    lnp = lnprob(pos) if batched else jax.vmap(lnprob)(pos)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    compiled = run_ensemble.lower(lnprob, pos, lnp, key, nsteps=nsteps,
                                  batched=batched).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(pos, lnp, key))       # warm
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(pos, lnp, jax.random.PRNGKey(1)))
    wall_us = 1e6 * (time.perf_counter() - t0) / nsteps  # profiler off
    out = trace_window(lambda: compiled(pos, lnp, jax.random.PRNGKey(2)),
                       nsteps, os.path.join(out_dir, name))
    with open(os.path.join(out_dir, f"{name}_lines.json"), "w") as fh:
        json.dump(out.pop("lines"), fh, indent=1)
    return {"cell": name, "nsteps": nsteps, "compile_s": compile_s,
            "untraced_us_per_step": wall_us, **out}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(REPO, "results",
                                                      "trace"))
    parser.add_argument("--steps", type=int, default=200)
    args = parser.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print("trace_step: no GPU; nothing was run.", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    os.makedirs(args.out, exist_ok=True)

    from __graft_entry__ import _flagship_problem
    from cha1_mcmc_tpu.catalogs.synthetic import (DENSE_BOUNDS, DENSE_TRUTH,
                                                  dense_problem)
    from cha1_mcmc_tpu.inference import build_lnprob, build_lnprob_batched

    rng = np.random.default_rng(0)
    model, spec, lnprior, ints, yerrs = _flagship_problem()
    pos = np.array([3.24e12, 7.5, 4.11, 0.78]) * (
        1 + 0.01 * rng.standard_normal((128, 4)))
    print(json.dumps(_cell("flagship", build_lnprob(model, spec, ints, yerrs,
                                                    lnprior),
                           pos, args.steps, False, args.out)), flush=True)

    p = dense_problem()
    truth = np.array([DENSE_TRUTH[k] for k in ("Ncol", "Tex", "vlsr", "dV")])
    lnprob = build_lnprob_batched(p["model"], p["spec"], p["ints"],
                                  p["yerrs"], p["lnprior"], use_pallas=True,
                                  dv_max=DENSE_BOUNDS["dV"][1])
    pos = truth * (1 + 0.01 * rng.standard_normal((128, 4)))
    print(json.dumps(_cell("dense", lnprob, pos, args.steps, True,
                           args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
