"""Workbench session, CLI, crosscheck, observation reader."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cha1_mcmc_tpu.pipeline.workbench import Workbench
from tests.conftest import requires_reference, CATALOG_DIR, HC5N_DATA, REFERENCE_ROOT


@requires_reference
def test_workbench_mutators_match_molsim(hc5n_catalog):
    """Workbench stick sims equal the reference MolSim under mutations."""
    from tests import reference_oracle

    classes, _, _ = reference_oracle.load_reference()
    ref_cat = classes.MolCat("hc5n_hfs", f"{CATALOG_DIR}/hc5n_hfs.cat")
    wb = Workbench(ll=18000, ul=25000, dish_size=70, source_size=52.0,
                   vlsr=0.0, dV=0.89, T=7.0, C=3.4e12)
    wb.load_mol(f"{CATALOG_DIR}/hc5n_hfs.cat")
    for T, C in [(7.0, 3.4e12), (9.5, 1e12), (5.0, 8e12)]:
        wb.modT(T)
        wb.modC(C)
        obs = classes.ObsParams("t", dish_size=70, source_size=52.0)
        sim = classes.MolSim("s", ref_cat, obs, vlsr=[0.0], C=[C], dV=[0.89],
                             T=[T], ll=[18000], ul=[25000], gauss=False)
        np.testing.assert_allclose(wb.int_sim, np.array(sim.int_sim), rtol=1e-10)
        np.testing.assert_allclose(wb.tau_sim, np.array(sim.tau_sim), rtol=1e-10)


@requires_reference
def test_workbench_store_recall_session(tmp_path):
    wb = Workbench(ll=18000, ul=25000, dish_size=70, source_size=52.0,
                   dV=0.89, T=7.0, C=3.4e12)
    wb.load_mol(f"{CATALOG_DIR}/hc5n_hfs.cat")
    wb.store("cold")
    wb.modT(10.0).store("hot")
    hot_ints = wb.int_sim.copy()
    wb.recall("cold")
    assert wb.T == 7.0
    wb.recall("hot")
    np.testing.assert_allclose(wb.int_sim, hot_ints)

    grid, thin = wb.sum_stored(thick=False)
    _, thick = wb.sum_stored(grid=grid, thick=True)
    assert np.isfinite(thin).all() and np.isfinite(thick).all()
    assert thin.max() > 0 and thick.max() > 0

    path = str(tmp_path / "session")
    wb.save_session(path)
    wb2 = Workbench.restore_session(path)
    assert set(wb2.stored) == {"cold", "hot"}
    np.testing.assert_allclose(wb2.stored["hot"]["ints"], hot_ints)

    # purge (reference simulate_lte.py:3459): removes one stored sim,
    # reports the bad key otherwise
    wb.purge("cold")
    assert set(wb.stored) == {"hot"}
    with pytest.raises(KeyError, match="cold"):
        wb.purge("cold")


@requires_reference
def test_workbench_vlsr_shift():
    wb = Workbench(ll=18000, ul=25000, dish_size=70, source_size=52.0,
                   dV=0.89, T=7.0, C=3.4e12)
    wb.load_mol(f"{CATALOG_DIR}/hc5n_hfs.cat")
    rest = wb.freq_sim.copy()
    wb.modVLSR(10.0)
    np.testing.assert_allclose(wb.freq_sim, rest * (1 - 10.0 / 2.998e5), rtol=1e-12)


@requires_reference
def test_read_obs_lis_equivalent(tmp_path):
    """read_obs parses a plain two-column file and sorts by frequency."""
    from cha1_mcmc_tpu.reduce.converters import read_obs

    path = str(tmp_path / "obs.txt")
    rng = np.random.default_rng(0)
    f = np.linspace(18000, 18010, 101)
    i = rng.normal(0, 1e-3, 101)
    order = rng.permutation(101)
    with open(path, "w") as fh:
        for a, b in zip(f[order], i[order]):
            fh.write(f"{a} {b}\n")
    freq, ints, res, rms = read_obs(path)
    np.testing.assert_allclose(freq, f)
    np.testing.assert_allclose(ints, i)   # intensities co-sorted with freqs
    assert res == pytest.approx(0.1, rel=1e-6)


@requires_reference
def test_grid_chi2_minimum_near_best_fit(hc5n_problem, hc5n_datagrid):
    from cha1_mcmc_tpu.analysis.crosscheck import grid_chi2

    model, spec = hc5n_problem["model"], hc5n_problem["spec"]
    grids = {
        "Ncol": np.linspace(1e12, 6e12, 21),
        "Tex": np.linspace(5.0, 10.0, 11),
        "vlsr": np.linspace(4.0, 4.2, 9),
        "dV": np.linspace(0.6, 1.0, 9),
    }
    thetas, chi2, best = grid_chi2(model, spec, hc5n_datagrid.ints,
                                   hc5n_datagrid.yerrs, grids)
    assert thetas.shape[0] == 21 * 11 * 9 * 9
    # grid minimum sits in the known posterior basin
    assert 2e12 < best[0] < 5e12
    assert abs(best[2] - 4.11) < 0.05
    assert 0.6 <= best[3] <= 0.9


def test_cli_fit(tmp_path, hc5n_inputs):
    cfg = {
        "mol_name": "hc5n_hfs", "template_run": True, "nruns": 5,
        "nwalkers": 8, "cat_folder": hc5n_inputs[0],
        "data_path": hc5n_inputs[1],
        "fit_folder": str(tmp_path / "results"), "MLE_for_Ncol": False,
        "checkpoint_every": 5,
    }
    cfg_path = str(tmp_path / "run.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run(
        [sys.executable, "-m", "cha1_mcmc_tpu", "fit", "--config", cfg_path],
        capture_output=True, text=True, env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert os.path.exists(tmp_path / "results" / "hc5n_hfs" / "chain_template.npy")


@requires_reference
def test_workbench_repl(tmp_path):
    """The interactive shell drives the full vocabulary from a piped
    script: load/mutate/store/sum/obs/stack/mf/plot/save/restore."""
    from cha1_mcmc_tpu.pipeline.repl import WorkbenchShell
    from cha1_mcmc_tpu.pipeline.workbench import Workbench
    import io as _io

    png = tmp_path / "h.png"
    sess = tmp_path / "sess"
    script = "\n".join([
        "limits 18000 25000 0.03",
        f"load_mol {CATALOG_DIR}/hc5n_hfs.cat",
        "modT 7.0", "modC 3.4e12", "moddV 0.89", "modVLSR 4.1",
        "set eta 0.9",
        "set eta 1.0",
        "set two_fwhm_only on",
        "set two_fwhm_only off",
        "set planck on",       # run_sim fails (no synth_beam yet) -> reverted
        "set synth_beam 10 6",
        "set nonsense 1",      # unknown attribute reports, not raises
        "set eta",             # missing value: usage line, not IndexError
        "status",
        "print_lines 3",
        "store cold",
        "modT 9.5",
        "store warm",
        "store scratch",
        "purge scratch",
        "sum",
        f"obs {HC5N_DATA}",
        "stack",
        "mf",
        f"plot harmonic 18638.6,21301.26 4.0 {png}",
        "baseline 1e-4",
        "residual",
        f"plot residual {tmp_path / 'resid.png'}",
        f"write current {tmp_path / 'cur.txt'}",
        "ulim 18630 18650",
        f"save {sess}",
        "bogus_command 1 2",   # unknown syntax must not kill the session
        "recall nonexistent",  # nor must a raising command
        "quit",
    ]) + "\n"
    out = _io.StringIO()
    wb = Workbench(ll=18000, ul=25000, res=0.03, dish_size=70,
                   source_size=52.0, dV=0.89, T=7.0, C=3.4e12, vlsr=4.1)
    shell = WorkbenchShell(wb, stdin=_io.StringIO(script), stdout=out)
    shell.cmdloop()
    text = out.getvalue()
    assert "re-simulated" in text
    assert "stored 'cold'" in text and "stored 'warm'" in text
    assert "purged 'scratch'" in text
    assert "summed 2 stored sims" in text
    assert "stack peak SNR" in text and "matched filter peak" in text
    assert "Unknown syntax" in text   # bogus command reported, not fatal
    assert "error: KeyError" in text  # raising command reported, not fatal
    assert "baseline subtracted" in text
    assert "residual over" in text
    assert "upper limit" in text
    assert png.stat().st_size > 1000
    assert (tmp_path / "resid.png").stat().st_size > 1000
    cur = (tmp_path / "cur.txt").read_text().splitlines()
    assert cur[0] == cur[1] and len(cur) > 10  # write_spectrum quirk
    assert (tmp_path / "sess.json").exists()

    restored = Workbench.restore_session(str(sess))
    assert set(restored.stored) == {"cold", "warm"}


@requires_reference
def test_cli_diagnose(tmp_path):
    """`python -m cha1_mcmc_tpu diagnose chain.npy` prints the tau/ESS/
    R-hat table and a convergence verdict."""
    rng = np.random.default_rng(0)
    chain = rng.normal(size=(16, 400, 3)).astype(np.float32)
    path = str(tmp_path / "chain.npy")
    np.save(path, chain)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run(
        [sys.executable, "-m", "cha1_mcmc_tpu", "diagnose", path],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-1000:]
    assert "R-hat" in out.stdout
    # iid normal draws: converged
    assert "converged (all R-hat < 1.05)" in out.stdout


@requires_reference
def test_plot_engines(tmp_path, hc5n_datagrid):
    """Postage/range/harmonic plots render; corner animation writes a GIF."""
    from cha1_mcmc_tpu.pipeline.plots import (
        postage_plot, range_plot, harmonic_plot, animate_corner)

    g = hc5n_datagrid
    lines = [18638.6, 21301.25, 23963.9]
    fig = postage_plot(g.freqs, g.ints, lines, dV=0.78, vlsr=4.11, velocity=True)
    fig.savefig(tmp_path / "postage.png", dpi=60)
    fig2 = range_plot(g.freqs, g.ints, [(18636, 18641), (21299, 21304)],
                      markers=lines)
    fig2.savefig(tmp_path / "range.png", dpi=60)
    # HC5N B0 ~ 1331.33 MHz: rows at the J=7-6/8-7/9-8 harmonics
    cfreqs = 2 * 1331.33 * np.array([7, 8, 9])
    fig3 = harmonic_plot(cfreqs, chunk_range=4.0, freq_obs=g.freqs,
                         int_obs=g.ints,
                         sims=[(g.freqs, g.ints * 0.5)], milli=True)
    assert len(fig3.axes) == 3
    # every row is recentred: x-limits symmetric about 0
    for ax in fig3.axes:
        lo, hi = ax.get_xlim()
        assert lo == -hi
    fig3.savefig(tmp_path / "harmonic.png", dpi=60)
    for f in ("postage.png", "range.png", "harmonic.png"):
        assert (tmp_path / f).stat().st_size > 1000

    rng = np.random.default_rng(0)
    chain = rng.normal(size=(8, 50, 3)) * [1, 2, 0.5] + [5.0, -1.0, 0.0]
    steps = animate_corner(chain, ["a", "b", "c"], str(tmp_path / "anim.gif"),
                           n_frames=4)
    assert (tmp_path / "anim.gif").stat().st_size > 5000
    assert len(steps) >= 2


@requires_reference
def test_workbench_gauss_mode_sum_and_matched_filter(tmp_path):
    """Regression: gauss-mode sessions can sum_stored(thick=True) (tau is
    per-line while freq_sim is the rendered grid) and matched_filter
    returns aligned (velocity, response)."""
    wb = Workbench(ll=18000, ul=19000, res=0.03, dish_size=70, source_size=52.0,
                   dV=0.89, T=7.0, C=3.4e12, gauss=True)
    wb.load_mol(f"{CATALOG_DIR}/hc5n_hfs.cat")
    assert wb.freq_sim.size != wb.tau_sim.size  # the gauss-mode mismatch
    wb.store("a").modT(9.0).store("b")
    grid, comp = wb.sum_stored(thick=True)
    assert np.isfinite(comp).all() and comp.max() > 0

    # matched filter alignment on synthetic obs
    rng = np.random.default_rng(0)
    wb.freq_obs = np.arange(18000.0, 19000.0, 0.03)
    wb.int_obs = rng.normal(0, 1e-3, wb.freq_obs.size) + np.interp(
        wb.freq_obs, wb.freq_sim, wb.int_sim) * 0.5
    wb.obs_res = 0.03
    vel, resp = wb.matched_filter()
    assert vel.shape == resp.shape
    assert np.isfinite(resp).any()


@requires_reference
def test_read_obs_casa_header_quirk(tmp_path):
    """The casaviewer header strip drops the first two data rows, exactly
    as the reference does (classes.py:441-454)."""
    from cha1_mcmc_tpu.reduce.converters import read_obs
    import sys
    from tests import reference_oracle

    path = str(tmp_path / "obs.ispec")
    lines = ["#title: test", "#xLabel: f [GHz]", "#region (world): box",
             "18.0 0.1", "18.001 0.2", "18.002 0.3", "18.003 0.4", "18.004 0.5"]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    freq, ints, res, rms = read_obs(path)
    # first two data rows dropped; GHz -> MHz conversion applied
    np.testing.assert_allclose(freq, [18002.0, 18003.0, 18004.0])
    np.testing.assert_allclose(ints, [0.3, 0.4, 0.5])
    # differential: the reference MolObs on the same file
    classes = reference_oracle.load_reference()[0]
    ref = classes.MolObs("t", path)
    np.testing.assert_allclose(ref.freq_obs, freq)
    np.testing.assert_allclose(ref.int_obs, ints)


@requires_reference
def test_presets_and_spec_converter(tmp_path):
    from cha1_mcmc_tpu.pipeline.presets import load_preset, PRESETS
    from cha1_mcmc_tpu.reduce.converters import spec_to_array

    cfg = load_preset("dsn_cha_mms1_hc5n", f"{REFERENCE_ROOT}/data", CATALOG_DIR)
    assert os.path.exists(cfg.data_path) and cfg.mol_name == "hc5n_hfs"
    cfg2 = load_preset("gotham_tmc1_hc9n", f"{REFERENCE_ROOT}/data", CATALOG_DIR)
    assert cfg2.ncomp == 4
    with pytest.raises(KeyError):
        load_preset("nope", "/tmp", CATALOG_DIR)
    with pytest.raises(FileNotFoundError):
        load_preset("dsn_cha_mms1_hc5n", "/nonexistent", CATALOG_DIR)

    # .spec converter roundtrip
    rng = np.random.default_rng(0)
    v = np.linspace(-20, 20, 201)
    i = rng.normal(0, 1e-3, v.size)
    path = str(tmp_path / "test.spec")
    np.savetxt(path, np.column_stack([v, i]))
    arr = spec_to_array(path, rest_freq_mhz=23963.9)
    assert arr.shape == (2, 201)
    assert np.all(np.diff(arr[0]) > 0)  # sorted ascending in frequency
    # v=0 maps to the rest frequency
    idx = np.argmin(np.abs(arr[0] - 23963.9))
    assert np.isclose(arr[1][idx], i[100])


@requires_reference
def test_workbench_multiwindow_sticks():
    """List-valued [ll, ul]: the stick sim concatenates per-window trims in
    order (reference trim_array append walk, functions.py:507-540), and
    equals the single-window runs pieced together."""
    wb = Workbench(ll=[18000.0, 23000.0], ul=[19000.0, 24000.0],
                   T=7.0, C=3.4e12, dV=0.89)
    wb.load_mol(f"{CATALOG_DIR}/hc5n_hfs.cat")
    multi_f, multi_i = wb.freq_rest.copy(), wb.int_sim.copy()
    pieces_f, pieces_i = [], []
    for a, b in [(18000.0, 19000.0), (23000.0, 24000.0)]:
        w = Workbench(ll=a, ul=b, T=7.0, C=3.4e12, dV=0.89)
        w.load_mol(f"{CATALOG_DIR}/hc5n_hfs.cat")
        pieces_f.append(w.freq_rest)
        pieces_i.append(w.int_sim)
    np.testing.assert_array_equal(multi_f, np.concatenate(pieces_f))
    np.testing.assert_array_equal(multi_i, np.concatenate(pieces_i))
    assert multi_f.size > 0
    # gauss mode renders per window on the same grid as single-window runs
    wb.gauss = True
    wb.run_sim()
    w0 = Workbench(ll=18000.0, ul=19000.0, T=7.0, C=3.4e12, dV=0.89, gauss=True)
    w0.load_mol(f"{CATALOG_DIR}/hc5n_hfs.cat")
    n0 = w0.freq_sim.size
    np.testing.assert_allclose(wb.freq_sim[:n0], w0.freq_sim)
    np.testing.assert_allclose(wb.int_sim[:n0], w0.int_sim)


@requires_reference
def test_workbench_mod_shortcuts():
    wb = Workbench(ll=18000.0, ul=25000.0, T=7.0, C=1.0e12, dV=0.89)
    wb.load_mol(f"{CATALOG_DIR}/hc5n_hfs.cat")
    wb.mod2()
    assert wb.C == 2.0e12
    wb.mod12()   # x1.2, not x12 (the reference's comment says so too)
    assert wb.C == pytest.approx(2.4e12)
    wb.mod_2()
    wb.mod_12()
    wb.mod10()
    wb.mod_10()
    assert wb.C == pytest.approx(1.0e12)


@requires_reference
def test_workbench_write_sim_params_and_npz(tmp_path):
    wb = Workbench(ll=18000.0, ul=25000.0, T=7.0, C=3.4e12, dV=0.89,
                   vlsr=4.1, source_size=52.0, dish_size=70.0)
    wb.load_mol(f"{CATALOG_DIR}/hc5n_hfs.cat")
    wb.load_obs(HC5N_DATA)

    out = wb.write_sim_params(str(tmp_path / "hc5n.sim_params"),
                              rms=True, lines=True, notes="verify run")
    text = open(out).read()
    assert f"Catalog File:\t{CATALOG_DIR}/hc5n_hfs.cat" in text
    assert "Column Density:\t3.40e+12 cm-2" in text
    assert f"Q(7.0)\t\t\t{int(wb.get_Q())}" in text
    assert "Qvib(7.0)\t\t1.00000" in text
    assert "RMS in Range:" in text
    assert "++++++Simulated Lines++++++" in text
    assert "++++++Notes++++++" in text and "verify run" in text
    # the embedded line table is the mK line_table
    for row in wb.line_table(mK=True):
        assert row in text

    wb.write_npz_spec(str(tmp_path / "obs.npz"))
    data = np.load(tmp_path / "obs.npz")
    np.testing.assert_array_equal(data["freq_obs"], wb.freq_obs)
    np.testing.assert_array_equal(data["int_obs"], wb.int_obs)


@requires_reference
def test_workbench_quickload_presets(tmp_path):
    """The vendored tool's quickload vocabulary as session presets
    (reference simulate_lte.py:7554-7998): parameters land on the session,
    the observation loads, windows autoset, and each preset's Tbg model
    evaluates."""
    from cha1_mcmc_tpu.pipeline.presets import (WORKBENCH_PRESETS,
                                                load_workbench_preset)

    assert len(WORKBENCH_PRESETS) == 16
    wb = load_workbench_preset("tmc1", HC5N_DATA)
    assert (wb.T, wb.dV, wb.vlsr, wb.source_size) == (8.0, 0.15, 5.82, 30.0)
    assert not np.isscalar(wb.ll)  # autoset_limits ran
    wb.load_mol(f"{CATALOG_DIR}/hc5n_hfs.cat")
    assert wb.freq_sim.size > 0
    # every preset constructs and its Tbg model evaluates at 20 GHz
    for name in WORKBENCH_PRESETS:
        w = load_workbench_preset(name)
        assert np.isfinite(w.tbg_at(2e4)), name
    with pytest.raises(KeyError):
        load_workbench_preset("nope")


@requires_reference
def test_workbench_planck_surfaces(tmp_path):
    """planck-mode parity surfaces fixed in round 2: line_table converts
    to Jy with Jy/mJy headers (reference print_lines :3792-3806 — run_sim
    applies the planck branch inside the :3719 call), sum_stored(thick)
    radiative-transfers at the *session* T (reference :3021-3024 quirk)
    and converts to Jy (:3025-3055), and write_sim_params records the
    synthesized beam instead of the dish (reference :5836-5839)."""
    from cha1_mcmc_tpu.analysis.conversions import planck_k_to_jy
    from cha1_mcmc_tpu.analysis.tbg import calc_tbg
    from cha1_mcmc_tpu.ops.lte import planck_J

    common = dict(ll=5000.0, ul=9000.0, T=12.0, C=5.0e12, dV=0.7, vlsr=0.0)
    wb_k = Workbench(**common)
    wb_k.load_mol(f"{CATALOG_DIR}/benzonitrile.cat")
    wb = Workbench(planck=True, synth_beam=[0.26, 0.26], **common)
    wb.load_mol(f"{CATALOG_DIR}/benzonitrile.cat")

    rows_k = wb_k.line_table(mK=False)
    rows = wb.line_table(mK=False)
    assert "Intensity (Jy)" in rows[2] and "Intensity (K)" in rows_k[2]
    assert "Intensity (mJy)" in wb.line_table(mK=True)[2]
    # data rows: Jy column == planck conversion of the K column
    for rk, rj in zip(rows_k[3:], rows[3:]):
        f, k_val = float(rk.split("\t")[0]), float(rk.split("\t")[1])
        j_val = float(rj.split("\t")[1])
        expect = float(planck_k_to_jy(np.array([k_val]), np.array([f]),
                                      [0.26, 0.26])[0])
        assert j_val == pytest.approx(expect, rel=1e-2, abs=1e-6)

    # sum_stored thick: session-T RT + planck conversion
    wb.store("a")
    wb.modT(40.0)
    wb.store("b")
    grid, ints = wb.sum_stored(thick=True)
    # manual recomputation with the session (current) T=40
    tau_total = np.zeros_like(grid)
    from cha1_mcmc_tpu.analysis.renderer import render_gaussian_profile
    for name in ("a", "b"):
        e = wb.stored[name]
        fg, tg = render_gaussian_profile(e["tau_freq"], e["tau"],
                                         dV=e["params"]["dV"], ll=grid[0],
                                         ul=grid[-1], res=wb.res)
        tau_total += np.interp(grid, fg, tg)
    tbg = calc_tbg(wb.tbg_params, wb.tbg_type, wb.tbg_range, grid)
    k_ints = (planck_J(np, grid, 40.0) - planck_J(np, grid, tbg)) * (
        1 - np.exp(-tau_total))
    np.testing.assert_allclose(
        ints, planck_k_to_jy(k_ints, grid, [0.26, 0.26]), rtol=1e-12)

    # write_sim_params: Synth Beam replaces Dish Size in planck sessions
    out = wb.write_sim_params(str(tmp_path / "p.sim_params"))
    text = open(out).read()
    assert "Synth Beam:\t\t[0.26, 0.26] arcsec" in text
    assert "Dish Size" not in text
    out_k = wb_k.write_sim_params(str(tmp_path / "k.sim_params"))
    assert "Dish Size" in open(out_k).read()


@requires_reference
def test_session_restores_observation(tmp_path):
    """restore_session reloads the saved observation by path, like the
    reference's restore (read_obs(active_dict['obs']))."""
    wb = Workbench(ll=18000.0, ul=25000.0)
    wb.load_obs(HC5N_DATA)
    path = str(tmp_path / "sess")
    wb.save_session(path)
    wb2 = Workbench.restore_session(path)
    assert wb2.obs_path == HC5N_DATA
    np.testing.assert_array_equal(wb2.freq_obs, wb.freq_obs)


def test_postage_plot_velocity_axis_reference_convention():
    """velocity=True uses the reference's relative axis (f - center) *
    c / center centered on the vlsr-shifted line: the source's own line
    peaks at x ~ 0 and an interloper at LSR velocity v sits at
    -(v - vlsr) (regression: a former +vlsr term mirrored the axis)."""
    from cha1_mcmc_tpu.pipeline.plots import postage_plot

    ckm = 2.998e5
    lf, vlsr, dV = 20000.0, 4.0, 0.5
    freq = np.arange(lf - 5.0, lf + 5.0, 0.005)
    sigma = dV * lf / ckm / 2.355
    ints = np.exp(-0.5 * ((freq - lf * (1 - vlsr / ckm)) / sigma) ** 2)
    fig = postage_plot(freq, ints, [lf], dV=dV, vlsr=vlsr, velocity=True)
    x, y = fig.axes[0].lines[0].get_data()
    assert x[np.argmax(y)] == pytest.approx(0.0, abs=0.1)
    # interloper at LSR 6.0 with the source at 4.0: offset -(6-4) = -2
    ints2 = np.exp(-0.5 * ((freq - lf * (1 - 6.0 / ckm)) / sigma) ** 2)
    fig2 = postage_plot(freq, ints2, [lf], dV=dV, vlsr=vlsr, velocity=True)
    x2, y2 = fig2.axes[0].lines[0].get_data()
    assert x2[np.argmax(y2)] == pytest.approx(-2.0, abs=0.1)
