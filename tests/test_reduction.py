"""Data reduction: golden parity with the reference pipeline."""

import contextlib
import io

import numpy as np

from cha1_mcmc_tpu.reduce.noise import calc_noise_std
from cha1_mcmc_tpu.reduce.datagrid import load_datagrid, save_datagrid
from cha1_mcmc_tpu.reduce.converters import lis_to_array, velocity_to_frequency
from tests.conftest import requires_reference, HC5N_DATA, REFERENCE_ROOT
from tests import reference_oracle


@requires_reference
def test_noise_std_matches_reference():
    _, _, inference = reference_oracle.load_reference()
    fitter = reference_oracle.make_reference_fitter(inference)
    data = np.load(HC5N_DATA, allow_pickle=True)
    rng = np.random.default_rng(0)
    for sl in [slice(0, 60), slice(100, 260), slice(0, 561)]:
        ref_mean, ref_std = fitter.calc_noise_std(data[1][sl])
        my_mean, my_std = calc_noise_std(data[1][sl])
        assert np.isclose(ref_mean, my_mean, rtol=0, atol=0) or ref_mean == my_mean
        assert ref_std == my_std
    # synthetic spectrum with an injected spike
    synth = rng.standard_normal(500) * 1e-3
    synth[250:253] += 0.05
    ref = fitter.calc_noise_std(synth)
    mine = calc_noise_std(synth)
    assert ref == mine


@requires_reference
def test_datagrid_golden_parity(hc5n_datagrid):
    """Byte-identical reduction vs the reference init_setup + read_file."""
    _, _, inference = reference_oracle.load_reference()
    fitter = reference_oracle.make_reference_fitter(inference)
    with contextlib.redirect_stdout(io.StringIO()):
        datafile, _ = fitter.init_setup()
    ref_grid = np.load(datafile, allow_pickle=True)
    np.testing.assert_array_equal(ref_grid[0], hc5n_datagrid.freqs)
    np.testing.assert_array_equal(ref_grid[1], hc5n_datagrid.ints)
    np.testing.assert_array_equal(ref_grid[2], hc5n_datagrid.yerrs)
    np.testing.assert_array_equal(ref_grid[3], hc5n_datagrid.covered_trans)


def test_datagrid_roundtrip(tmp_path, hc5n_datagrid):
    path = str(tmp_path / "grid.npy")
    save_datagrid(path, hc5n_datagrid)
    loaded = load_datagrid(path)
    np.testing.assert_array_equal(loaded.freqs, hc5n_datagrid.freqs)
    np.testing.assert_array_equal(loaded.covered_trans, hc5n_datagrid.covered_trans)


@requires_reference
def test_lis_converter_matches_npy():
    """The shipped .lis file holds the same spectrum as the .npy fixture
    (reference data/DSN/cha-mms1-hc5n-example.lis header notes vlsr 4.1)."""
    lis = lis_to_array(f"{REFERENCE_ROOT}/data/DSN/cha-mms1-hc5n-example.lis")
    npy = np.load(HC5N_DATA, allow_pickle=True)
    assert lis.shape[1] == npy.shape[1]
    np.testing.assert_allclose(lis[0], npy[0], rtol=1e-9)
    np.testing.assert_allclose(lis[1], npy[1], rtol=1e-6, atol=1e-12)


def test_velocity_to_frequency_roundtrip():
    v = np.linspace(-10, 10, 101)
    f = velocity_to_frequency(v, 20000.0)
    np.testing.assert_allclose((1 - f / 20000.0) * 2.998e5, v, atol=1e-9)
