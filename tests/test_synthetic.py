"""Seeded synthetic inputs (catalogs/synthetic.py): the SPCAT writer's
round trip through the parser, the flagship shape after the unchanged
reduction, and the dense problem's shape."""

import os

import numpy as np
import pytest

from cha1_mcmc_tpu.catalogs import load_catalog
from cha1_mcmc_tpu.catalogs.partition import q_model_for_catalog
from cha1_mcmc_tpu.catalogs.synthetic import (
    HC5N, HC5N_TRUTH, _wigner6j, dense_lines, dense_problem, dsn_spectrum,
    linear_rotor_hfs_lines, write_hc5n_inputs, write_spcat)
from cha1_mcmc_tpu.reduce.datagrid import reduce_spectrum

# The flagship shape at seed 0: the reference Cha-MMS1 HC5N datagrid has
# the same 9 covered lines (3 hyperfine triplets of J = 7-6, 8-7, 9-8)
# over ~561 channels.
FLAGSHIP_COVERED = [2, 3, 4, 8, 9, 10, 14, 15, 16]
FLAGSHIP_CHANNELS = 564


def test_wigner6j_known_values():
    """Racah's formula against tabulated symbols and the orthogonality
    relation sum_x (2x+1)(2c+1) {a b x; d e c}{a b x; d e c'} = delta."""
    assert _wigner6j(1, 1, 1, 1, 1, 1) == pytest.approx(1 / 6)
    assert _wigner6j(1, 1, 0, 1, 1, 0) == pytest.approx(1 / 3)
    assert _wigner6j(2, 1, 1, 1, 2, 1) == pytest.approx(-np.sqrt(5) / 10)
    assert _wigner6j(1, 1, 3, 1, 1, 1) == 0.0  # triangle rule fails
    a, b, d, e = 3, 1, 2, 2  # c in 1..3 satisfies both triangles
    for c in range(1, 4):
        for c2 in range(1, 4):
            total = sum((2 * x + 1) * (2 * c + 1)
                        * _wigner6j(a, b, x, d, e, c)
                        * _wigner6j(a, b, x, d, e, c2)
                        for x in range(0, 6))
            assert total == pytest.approx(float(c == c2), abs=1e-12)


def test_linear_rotor_hfs_line_list():
    """63 lines for J' <= 11; hyperfine strengths of each rotational line
    sum to the rigid-rotor 3 J' mu^2; frequencies near 2 B J'."""
    lines = linear_rotor_hfs_lines()
    assert lines["freq"].size == 3 + 6 * 10
    assert np.all(np.diff(lines["freq"]) > 0)
    ju = lines["qn_up"][:, 0]
    for J in range(1, 12):
        sel = ju == J
        assert lines["sijmu"][sel].sum() == pytest.approx(3 * J * HC5N["mu"] ** 2)
        np.testing.assert_allclose(lines["freq"][sel], 2 * HC5N["B"] * J,
                                   atol=5.0)
    assert (lines["aij"] > 0).all() and (lines["gup"] >= 1).all()


def test_spcat_round_trip(tmp_path):
    """write_spcat -> parse_spcat: frequencies to the 4-decimal field,
    Einstein A to the log-intensity rounding, quantum numbers exact; the
    file name resolves the analytic HFS partition function."""
    lines = linear_rotor_hfs_lines()
    path = str(tmp_path / "hc5n_hfs.cat")
    write_spcat(path, lines)
    cat = load_catalog(path)
    assert cat.frequency.size == 63
    np.testing.assert_allclose(cat.frequency, lines["freq"], atol=5e-5)
    np.testing.assert_allclose(cat.aij, lines["aij"], rtol=3e-4)
    np.testing.assert_array_equal(cat.gup, lines["gup"])
    np.testing.assert_allclose(cat.elower, lines["elower"], atol=5e-5)
    assert q_model_for_catalog(cat).kind == "analytic"


def test_flagship_inputs_reduce_to_reference_shape(tmp_path):
    """Seed 0 through the unchanged reduce_spectrum: 9 covered lines x
    564 channels over 18-25 GHz; the spectrum is a function of the seed."""
    cat_folder, data_path = write_hc5n_inputs(str(tmp_path / "a"), seed=0)
    assert os.path.exists(os.path.join(cat_folder, "hc5n_hfs.cat"))
    cat = load_catalog(os.path.join(cat_folder, "hc5n_hfs.cat"))
    grid = reduce_spectrum(
        cat, data_path, ll=18000, ul=25000,
        aligned_velocity=HC5N_TRUTH["aligned_velocity"],
        dish_size=HC5N_TRUTH["dish_size"],
        source_size=HC5N_TRUTH["source_size"], block_interlopers=True,
        verbose=False)
    assert grid.covered_trans.tolist() == FLAGSHIP_COVERED
    assert grid.freqs.size == FLAGSHIP_CHANNELS
    assert 18_000 < grid.freqs.min() and grid.freqs.max() < 25_000
    assert np.isfinite(grid.ints).all() and (grid.yerrs > 0).all()

    spec = np.load(data_path)
    _, data_b = write_hc5n_inputs(str(tmp_path / "b"), seed=0)
    np.testing.assert_array_equal(spec, np.load(data_b))
    other = dsn_spectrum(cat, seed=1)
    np.testing.assert_array_equal(other[0], spec[0])
    assert not np.array_equal(other[1], spec[1])


def test_dense_problem_shape():
    """The dense generator: 35,460 sorted lines by default; the small
    problem keeps the channel count and evaluates finite at the truth."""
    d = dense_lines()
    assert d["freq"].size == 35_460
    assert np.all(np.diff(d["freq"]) >= 0)
    p = dense_problem(n_lines=1_000, n_channels=512, seed=1)
    assert p["model"].n_lines == 1_000 and p["model"].n_channels == 512
    assert p["ints"].shape == p["yerrs"].shape == (512,)
    assert np.isfinite(p["ints"]).all()
