"""Failure-proofing gates for the bench harness (bench.py).

These tests force each failure mode — a section raising, a device section
on a host without an accelerator, a section hanging past the deadline, an
external kill — and require that the emitted artifact still parses and
preserves every completed section.
"""

import json
import os
import subprocess
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB_DEVICE = {"platform": "gpu", "kind": "stub", "count": 1}


def _baseline_stub():
    return {"rate": 1000.0, "single_core_rate": 1000.0, "cores": 1,
            "evals": 10, "seconds": 0.01}


def _flagship_stub():
    return {"rate": 5e6, "us_per_step": 25.6, "fixed_ms_per_call": 0.1,
            "steps": 10, "nwalkers": 128, "n_lines": 9, "n_channels": 561,
            "acceptance": 0.5, "device": STUB_DEVICE}


def _subprocess_env(**extra):
    return dict(os.environ, JAX_PLATFORMS="cpu", **extra)


def test_section_failure_preserves_other_sections(tmp_path):
    """One raising section must not destroy the artifact: completed
    sections keep their values; the failed one records ok=False + error."""
    def boom():
        raise RuntimeError("synthetic section failure")

    partial = tmp_path / "partial.json"
    sections = [("baseline", _baseline_stub),
                ("flagship", _flagship_stub),
                ("dense", boom)]
    results = bench.run_sections(sections, deadline_s=60,
                                 partial_path=str(partial))
    out = bench._assemble(results)
    assert out["value"] == 5e6
    assert out["vs_baseline"] == 5000.0
    assert out["device"] == STUB_DEVICE
    assert out["dense_35k_lines"]["ok"] is False
    assert "synthetic section failure" in out["dense_35k_lines"]["error"]
    # Partial sidecar parses and already holds the completed sections.
    disk = json.loads(partial.read_text())
    assert disk["value"] == 5e6
    # The artifact is one parseable JSON object end-to-end.
    json.loads(json.dumps(out))


def test_backend_outage_marks_device_sections_and_keeps_cpu(tmp_path):
    """No accelerator (this CPU test host): the real flagship section
    fails with the reason recorded as data instead of timing the CPU under
    a device metric's name; the CPU baseline still lands; the headline
    value degrades to null instead of the process dying."""
    sections = [("baseline", _baseline_stub),
                ("flagship", bench.bench_flagship)]
    results = bench.run_sections(sections, deadline_s=60,
                                 partial_path=str(tmp_path / "p.json"))
    out = bench._assemble(results)
    assert results["flagship"]["ok"] is False
    assert "no accelerator" in out["flagship_error"]
    assert out["value"] is None and out["vs_baseline"] is None
    assert out["baseline_walker_steps_per_sec"] == 1000.0


def test_watchdog_emits_partial_json_on_hang():
    """A section hanging past the deadline (a hung device call cannot be
    interrupted in-process) force-emits the completed sections and exits 0.
    Runs in a subprocess because the watchdog uses os._exit."""
    code = """
import sys, time
sys.path.insert(0, {repo!r})
import bench

def ok():
    return {{"rate": 1.0, "single_core_rate": 1.0, "cores": 1,
             "evals": 1, "seconds": 0.0}}

def hang():
    time.sleep(60)

bench.run_sections([("baseline", ok), ("flagship", hang)],
                   deadline_s=1.0, partial_path=None)
print("UNREACHABLE")
""".format(repo=REPO)
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=30, env=_subprocess_env())
    assert proc.returncode == 0
    assert "UNREACHABLE" not in proc.stdout
    line = [l for l in proc.stdout.splitlines() if l.startswith("{")][-1]
    out = json.loads(line)
    assert out["watchdog_fired"] is True
    assert out["baseline_walker_steps_per_sec"] == 1.0
    assert "watchdog" in out["flagship_error"]
    assert time.time() - t0 < 25


def test_main_streams_sections_and_ends_with_artifact(capsys, monkeypatch):
    """main() end-to-end with stub sections: one JSON line per section as
    it completes (the hard-kill survival channel), artifact LAST, naming
    the device the run saw."""
    monkeypatch.setenv("CHA1_BENCH_PARTIAL", "")
    bench.main(sections=[("baseline", _baseline_stub),
                         ("flagship", _flagship_stub)])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 3
    sections = [json.loads(l) for l in lines[:-1]]
    assert [s["bench_section"] for s in sections] == ["baseline", "flagship"]
    assert all(s["ok"] for s in sections)
    out = json.loads(lines[-1])
    assert out["metric"] == "walker_steps_per_sec_hc5n"
    assert out["value"] == 5e6
    assert set(out["device"]) == {"platform", "kind", "count"}
    assert out["device"]["platform"] == "cpu"  # main() reports the real host


def test_hard_kill_leaves_streamed_sections_parseable(tmp_path):
    """An external SIGKILL mid-section: the already-streamed per-section
    JSON lines must be recoverable from the (possibly truncated) captured
    output even though no final artifact was ever emitted."""
    import signal

    code = """
import sys, time
sys.path.insert(0, {repo!r})
import bench

def ok():
    return {{"rate": 1.0, "single_core_rate": 1.0, "cores": 1,
             "evals": 1, "seconds": 0.0}}

def flagship():
    return {{"rate": 5e6, "us_per_step": 25.6, "acceptance": 0.5,
             "device": {{"platform": "gpu", "kind": "stub", "count": 1}}}}

def hang():
    print("HANG-MARKER", flush=True)
    time.sleep(120)

bench.run_sections([("baseline", ok), ("flagship", flagship),
                    ("dense", hang)], deadline_s=300.0, partial_path=None)
""".format(repo=REPO)
    out_path = tmp_path / "stdout.txt"
    with open(out_path, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=fh,
                                stderr=subprocess.DEVNULL,
                                env=_subprocess_env())
        t0 = time.time()
        # Wait until the hanging section started (its sections streamed).
        while time.time() - t0 < 30:
            if "HANG-MARKER" in out_path.read_text():
                break
            time.sleep(0.2)
        proc.send_signal(signal.SIGKILL)  # exact-PID kill, never by pattern
        proc.wait(timeout=30)
    assert proc.returncode != 0  # genuinely killed, no artifact line
    lines = [l for l in out_path.read_text().splitlines()
             if l.startswith("{")]
    recovered = {json.loads(l)["bench_section"]: json.loads(l)
                 for l in lines}
    assert recovered["baseline"]["ok"] and recovered["flagship"]["ok"]
    assert recovered["flagship"]["rate"] == 5e6


def test_watchdog_artifact_escapes_chatter_redirect(tmp_path):
    """redirect_stdout is process-wide: when the watchdog fires while a
    section has bench._chatter() active, the emitted artifact must still
    reach the REAL stdout, not the chatter file."""
    code = """
import sys, time
sys.path.insert(0, {repo!r})
import bench

def ok():
    return {{"rate": 1.0, "single_core_rate": 1.0, "cores": 1,
             "evals": 1, "seconds": 0.0}}

def hang_in_chatter():
    with bench._chatter():
        print("this goes to the chatter file")
        time.sleep(60)

bench.run_sections([("baseline", ok), ("flagship", hang_in_chatter)],
                   deadline_s=1.0, partial_path=None)
""".format(repo=REPO)
    env = _subprocess_env(CHA1_BENCH_LOG=str(tmp_path / "chatter.log"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=30, env=env)
    assert proc.returncode == 0
    stdout_jsons = [json.loads(l) for l in proc.stdout.splitlines()
                    if l.startswith("{")]
    art = stdout_jsons[-1]
    assert art["watchdog_fired"] is True
    assert "watchdog" in art["flagship_error"]
    # The chatter print stayed off stdout (it sits in the redirect
    # buffer, unflushed by os._exit), and the artifact stayed out of the
    # chatter file.
    assert "this goes to the chatter file" not in proc.stdout
    assert "watchdog_fired" not in (tmp_path / "chatter.log").read_text()


@pytest.mark.parametrize("t_short,t_long,ok", [
    (0.010, 0.040, True),     # 10 ms/unit: a real slope
    (0.010, 0.010, False),    # flat: the long run cost nothing extra
    (0.010, 0.005, False),    # negative slope
    (0.0100, 0.01003, False), # below 1% of the naive per-unit time
])
def test_slope_guard_rejects_collapsed_measurements(monkeypatch, t_short,
                                                    t_long, ok):
    """_slope_timed raises (marking the section not ok) on a non-positive
    or collapsed slope — every section's rate goes through this guard."""
    clock = {"t": 0.0}
    monkeypatch.setattr(bench.time, "perf_counter", lambda: clock["t"])

    def run(n, tag):
        clock["t"] += t_short if n == 10 else t_long
        return 0

    if ok:
        slope, fixed_ms = bench._slope_timed(run, 10, 40, reps=2)
        assert slope == pytest.approx((t_long - t_short) / 30)
        assert fixed_ms == pytest.approx((t_short - 10 * slope) * 1e3)
    else:
        with pytest.raises(RuntimeError, match="collapsed slope"):
            bench._slope_timed(run, 10, 40, reps=2)
