"""chip_smoke.py on a host without a GPU: it refuses to run, prints no
result, and its phases pass at small sizes on the CPU."""

import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _run_script(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def _has_result_line(stdout: str) -> bool:
    return any(line.startswith("{") and '"ok"' in line
               for line in stdout.splitlines())


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_exits_nonzero_without_gpu(args):
    proc = _run_script(REPO, *args)
    assert proc.returncode != 0
    assert not _has_result_line(proc.stdout)
    assert "no GPU" in proc.stderr


def test_exits_nonzero_outside_the_repo(tmp_path):
    """The script alone, without the package beside it, fails too."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path))
    assert proc.returncode != 0
    assert not _has_result_line(proc.stdout)


def _stub_main(monkeypatch, workdir, fail=None):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(cs, "card_identity", lambda: "Stub GPU, 700.00 W")
    monkeypatch.setattr(cs, "WORKDIR", str(workdir))

    def phase(name, **extra):
        def fn(*args, **kwargs):
            if name == fail:
                raise AssertionError(f"{name} failed on purpose")
            return {"us_per_step": 1.0, **extra}
        return fn

    monkeypatch.setattr(cs, "phase_flagship_fit",
                        phase("flagship_fit", fit=object()))
    monkeypatch.setattr(cs, "phase_flagship_parity", phase("flagship_lnprob"))
    monkeypatch.setattr(cs, "phase_dense", phase("dense"))


def test_main_last_line_is_the_contract(monkeypatch, capsys, tmp_path):
    _stub_main(monkeypatch, tmp_path)
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "card: Stub GPU, 700.00 W"
    assert any(l.startswith("timings [Stub GPU, 700.00 W]") for l in lines)
    out = json.loads(lines[-1])
    assert out["ok"] is True
    assert set(out["device"]) == {"platform", "kind", "count"}
    for name in ("flagship_fit", "flagship_lnprob", "dense"):
        assert any(l.startswith(f"phase {name}: ok") for l in lines)


@pytest.mark.parametrize("failing", ["flagship_fit", "flagship_lnprob",
                                     "dense"])
def test_main_failed_phase_exits_nonzero(monkeypatch, capsys, tmp_path,
                                         failing):
    """A failing phase is reported with its traceback, the others still
    run, and no result line is printed."""
    _stub_main(monkeypatch, tmp_path, fail=failing)
    assert cs.main([]) == 1
    out = capsys.readouterr().out
    assert f"phase {failing}: FAILED" in out
    assert f"{failing} failed on purpose" in out
    assert not _has_result_line(out)
    assert "phase dense:" in out


@pytest.fixture(scope="module")
def small_fit(tmp_path_factory):
    return cs.phase_flagship_fit(
        str(tmp_path_factory.mktemp("smoke")), nwalkers=32, nruns=300,
        checkpoint_every=150, log=io.StringIO())


def test_phase_flagship_fit_small(small_fit):
    """Shape, finiteness, acceptance band, truth recovery and the
    bitwise same-seed rerun, at 32 walkers x 300 steps."""
    assert small_fit["fit"].sampler.chain.shape == (32, 300, 4)
    assert cs.ACCEPTANCE[0] < small_fit["acceptance"] < cs.ACCEPTANCE[1]
    assert max(small_fit["z_tex_vlsr_dv"]) < cs.RECOVERY_SIGMA


def test_phase_flagship_parity_small(small_fit):
    out = cs.phase_flagship_parity(small_fit["fit"], nwalkers=16)
    assert out["rel_err"] <= cs.LNPROB_RTOL
    assert np.isfinite(out["us_per_step"]) and out["us_per_step"] > 0


def test_phase_mesh_lnprob_small(small_fit):
    out = cs.phase_mesh_lnprob(small_fit["fit"], n_devices=8,
                               n_line_shards=2, nwalkers=16)
    assert out["rel_err"] <= cs.LNPROB_RTOL


def test_phase_dense_small():
    """2,100 lines x 2,048 channels: still past the auto-rule threshold,
    so the phase exercises the sparse gather it checks."""
    out = cs.phase_dense(n_lines=2100, n_channels=2048, nwalkers=16,
                         n_check=4, n_steps=20)
    assert out["rel_err"] <= cs.LNPROB_RTOL
    assert (out["n_lines"], out["n_channels"]) == (2100, 2048)


def test_phase_mesh_dense_small():
    out = cs.phase_mesh_dense(n_shards=4, n_lines=2100, nwalkers=16)
    assert out["rel_err"] <= cs.LNPROB_RTOL
