"""Catalog layer: SPCAT parsing and partition functions, differentially
tested against the read-only reference implementation."""

import glob
import os

import numpy as np
import pytest

from cha1_mcmc_tpu.catalogs import load_catalog, q_model_for_catalog
from tests.conftest import CATALOG_DIR, requires_reference
from tests import reference_oracle

ALL_CATALOGS = sorted(glob.glob(os.path.join(CATALOG_DIR, "*.cat")))
# Representative subset for the expensive full-parity check: small + hfs +
# power-law aromatic + state-sum fallback (misspelled pattern) + big.
PARITY_SUBSET = [
    "hc5n_hfs", "hc3n", "hc7n_hfs", "hc9n_hfs", "benzonitrile",
    "azulene", "indene", "acenaphthylene", "cyclopentadiene", "C8H-",
]


@requires_reference
def test_all_catalogs_parse():
    assert len(ALL_CATALOGS) >= 35
    for path in ALL_CATALOGS:
        cat = load_catalog(path)
        assert len(cat) > 0
        assert np.all(np.isfinite(cat.frequency))
        assert np.all(cat.frequency > 0)
        assert np.all(np.isfinite(cat.sijmu))
        assert np.all(cat.gup > 0)
        assert np.all(cat.glow > 0)
        # eupper derivation (reference classes.py:90)
        np.testing.assert_allclose(
            cat.eupper, cat.elower + cat.frequency / 29979.2458)


@requires_reference
@pytest.mark.parametrize("name", PARITY_SUBSET)
def test_catalog_parity_with_reference(name):
    classes, functions, _ = reference_oracle.load_reference()
    path = os.path.join(CATALOG_DIR, f"{name}.cat")
    ref = classes.MolCat(name, path)
    mine = load_catalog(path)
    np.testing.assert_array_equal(ref.frequency, mine.frequency)
    np.testing.assert_array_equal(ref.gup, mine.gup)
    np.testing.assert_array_equal(ref.glow, mine.glow)
    np.testing.assert_allclose(ref.eupper, mine.eupper)
    np.testing.assert_allclose(ref.sijmu, mine.sijmu)
    np.testing.assert_allclose(ref.aij, mine.aij)
    assert ref.qns == mine.qns


@requires_reference
@pytest.mark.parametrize("name", PARITY_SUBSET)
def test_partition_function_parity(name):
    classes, functions, _ = reference_oracle.load_reference()
    path = os.path.join(CATALOG_DIR, f"{name}.cat")
    ref = classes.MolCat(name, path)
    mine = load_catalog(path)
    qm = q_model_for_catalog(mine)
    for T in (3.5, 5.0, 7.33, 12.0, 60.0, 300.0):
        assert np.isclose(functions.calc_q(ref, T), qm.host_eval(T), rtol=1e-12), (name, T)


def test_partition_function_jittable(hc5n_catalog):
    import jax
    import jax.numpy as jnp

    qm = q_model_for_catalog(hc5n_catalog)
    q_jit = jax.jit(qm)
    assert np.isclose(float(q_jit(jnp.float32(7.0))), qm.host_eval(7.0), rtol=1e-6)


@requires_reference
def test_state_sum_fallback_used_for_misspelled_patterns():
    # '1-cyanonapthalene.cat' / 'acenaphthylene.cat' do not match the
    # reference's (misspelled) dispatch patterns, so both must take the
    # generic state-sum fallback — same as the reference does.
    for name in ("acenaphthylene",):
        cat = load_catalog(os.path.join(CATALOG_DIR, f"{name}.cat"))
        assert q_model_for_catalog(cat).kind == "states"
    # while correctly-spelled patterns use analytic forms
    cat = load_catalog(os.path.join(CATALOG_DIR, "azulene.cat"))
    assert q_model_for_catalog(cat).kind == "analytic"


@requires_reference
def test_trim_indices_matches_reference(hc5n_catalog):
    classes, functions, _ = reference_oracle.load_reference()
    freq = hc5n_catalog.frequency
    for ll, ul in [(18000, 25000), (0, 1e9), (26000, 27000), (1e9, 2e9)]:
        ref_trim = functions.trim_array(freq, freq, [ll], [ul])
        i, i2 = hc5n_catalog.trim_indices(ll, ul)
        np.testing.assert_array_equal(ref_trim, freq[i:i2])


@requires_reference
def test_native_tokenizer_matches_python():
    """The C++ tokenizer and the pure-Python tokenizer agree on every
    shipped catalog, field for field."""
    from cha1_mcmc_tpu.catalogs.native import native_available, tokenize_native
    from cha1_mcmc_tpu.catalogs.spcat import _tokenize_python

    if not native_available():
        pytest.skip("native toolchain unavailable")
    for path in ALL_CATALOGS:
        with open(path, "rb") as fh:
            raw = fh.read()
        nat = tokenize_native(raw)
        py = _tokenize_python([ln for ln in raw.decode().splitlines() if ln.strip()])
        for key in py:
            np.testing.assert_array_equal(nat[key], py[key], err_msg=f"{path}:{key}")


@requires_reference
def test_calc_qvib_matches_reference_formula():
    """Q_vib vs the reference's truncated harmonic sum
    (simulate_lte.py:1293-1313), evaluated both ways."""
    from cha1_mcmc_tpu.catalogs import calc_qvib

    assert calc_qvib(None, 10.0) == 1.0
    vibs, T = [100.0, 250.0], 150.0
    expected = 1.0
    for x in vibs:
        expected *= sum(np.exp(-x * y / (0.695 * T)) for y in range(100))
    assert np.isclose(calc_qvib(vibs, T), expected, rtol=1e-12)
    import jax.numpy as jnp

    assert np.isclose(float(calc_qvib(vibs, jnp.float32(T), xp=jnp)), expected, rtol=1e-5)


def test_scale_temp_roundtrip(hc5n_catalog):
    """Scaling CT->T->CT returns the original intensities; scaling the
    catalog intensities from 300 K reproduces direct simulation ratios."""
    from cha1_mcmc_tpu.ops import scale_temp
    from cha1_mcmc_tpu.catalogs import q_model_for_catalog

    qm = q_model_for_catalog(hc5n_catalog)
    T, CT = 7.0, 300.0
    Q_T, Q_CT = qm.host_eval(T), qm.host_eval(CT)
    scaled = scale_temp(np, hc5n_catalog.intensity, hc5n_catalog.elower, T, CT, Q_T, Q_CT)
    back = scale_temp(np, scaled, hc5n_catalog.elower, CT, T, Q_CT, Q_T)
    np.testing.assert_allclose(back, hc5n_catalog.intensity, rtol=1e-10)


@requires_reference
def test_parity_label_qns_synthetic(tmp_path):
    """No shipped catalog contains '+'/'-' parity QN fields, so that decode
    path (reference fix_pm, functions.py:330-335) is verified here on a
    synthetic catalog against the reference parser and both tokenizers."""
    from cha1_mcmc_tpu.catalogs.native import native_available, tokenize_native
    from cha1_mcmc_tpu.catalogs.spcat import _tokenize_python
    from tests import reference_oracle

    # SPCAT fixed-width rows; QN columns at 55+2q. Column qn3 carries
    # '+'/'-'/'' entries, column qn4 mixes ints with an empty field.
    def row(freq, elow, gup, qns):
        qn_str = "".join(f"{q:>2}" for q in qns)
        return (f"{freq:13.4f}{0.001:8.4f}{-5.0:8.4f} 2{elow:10.4f}"
                f"{gup:3d}    123 304{qn_str}")

    lines = [
        row(10000.0, 0.0, 3, ["1", "0", "+", "1", "", "", "0", "0", "-", "1", "", ""]),
        row(12000.0, 0.3, 5, ["2", "0", "-", "2", "", "", "1", "0", "+", "1", "", ""]),
        row(14000.0, 0.7, 7, ["3", "0", "+", "", "", "", "2", "0", "-", "2", "", ""]),
    ]
    path = str(tmp_path / "synthetic_pm.cat")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")

    classes, _, _ = reference_oracle.load_reference()
    ref = classes.MolCat("pm", path)
    mine = load_catalog(path)
    # parity labels decoded column-wide: '+'->1, '-'->2, ''->0
    ref_qn = np.vstack([getattr(ref, f"qn{i}") for i in range(1, 13)]).T.astype(int)
    np.testing.assert_array_equal(mine.qn, ref_qn)
    np.testing.assert_array_equal(ref.gup, mine.gup)
    np.testing.assert_array_equal(ref.glow, mine.glow)
    np.testing.assert_allclose(ref.sijmu, mine.sijmu)
    if native_available():
        with open(path, "rb") as fh:
            nat = tokenize_native(fh.read())
        np.testing.assert_array_equal(nat["qn"], mine.qn)


@requires_reference
def test_qn12_reads_to_end_of_line(tmp_path):
    """qn12 spans column 77 to end-of-line in the reference parser
    (classes.py:178: x[line][77:]), not a 2-char field — verified on a
    synthetic catalog with rows wider than 79 columns, against the
    reference parser and both tokenizers."""
    from cha1_mcmc_tpu.catalogs.native import native_available, tokenize_native
    from cha1_mcmc_tpu.catalogs.spcat import _tokenize_python
    from tests import reference_oracle

    def row(freq, elow, gup, qns, tail=""):
        qn_str = "".join(f"{q:>2}" for q in qns)
        return (f"{freq:13.4f}{0.001:8.4f}{-5.0:8.4f} 2{elow:10.4f}"
                f"{gup:3d}    123 304{qn_str}{tail}")

    # last QN written as 3 digits: chars 77:80 = '123'
    lines = [
        row(10000.0, 0.0, 3, ["1", "0", "0", "1", "", "", "0", "0", "0", "1", "", "1"], "23"),
        row(12000.0, 0.3, 5, ["2", "0", "0", "2", "", "", "1", "0", "0", "1", "", "9"], "87"),
        row(14000.0, 0.7, 7, ["3", "0", "0", "3", "", "", "2", "0", "0", "2", "", "7"]),
    ]
    path = str(tmp_path / "wide_qn12.cat")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")

    classes, _, _ = reference_oracle.load_reference()
    ref = classes.MolCat("wide", path)
    mine = load_catalog(path)
    assert list(mine.qn[:, 11]) == [123, 987, 7]
    ref_qn = np.vstack([getattr(ref, f"qn{i}") for i in range(1, 13)]).T.astype(int)
    np.testing.assert_array_equal(mine.qn, ref_qn)
    np.testing.assert_array_equal(ref.glow, mine.glow)
    if native_available():
        with open(path, "rb") as fh:
            nat = tokenize_native(fh.read())
        np.testing.assert_array_equal(nat["qn"], mine.qn)


def test_chebyshev_device_q_surrogate(tmp_path):
    """fit_device_cheb (catalogs/partition.py): the device Chebyshev
    surrogate for huge state-sum Q models — the aromatics' 16k-state
    Boltzmann sum is a (walkers x states) exp per evaluation, while a
    degree-~16 fit reproduces Q far below f32 resolution. On a seeded
    16,488-state model (the size of 1-cyanonaphthalene's): (a) the fit
    meets its tolerance against the exact host state sum across the box,
    (b) host_eval is EXACTLY the state-sum formula (the f64 parity oracle
    must never see the surrogate), (c) the jitted device path uses the
    surrogate, (d) analytic models pass through untouched."""
    import jax
    import jax.numpy as jnp

    from cha1_mcmc_tpu.catalogs.partition import QModel, fit_device_cheb
    from cha1_mcmc_tpu.catalogs.synthetic import write_hc5n_inputs

    rng = np.random.default_rng(0)
    J = rng.integers(0, 120, 16_488)
    qm = QModel(kind="states", g=(2.0 * J + 1.0),
                E=rng.exponential(40.0, J.size))

    qd = fit_device_cheb(qm, 3.5, 12.0)
    assert qd.cheb_coeffs is not None and qd.cheb_interval == (3.5, 12.0)

    T = np.linspace(3.5, 12.0, 1777)
    exact = qm.host_eval(T)
    # (b) host oracle unchanged, bit for bit
    np.testing.assert_array_equal(qd.host_eval(T), exact)
    # (a) fit accuracy: the fitter's own tol is 1e-10; check with margin
    dev64 = np.asarray(qd._cheb_eval(np, T))
    assert np.max(np.abs(dev64 / exact - 1.0)) < 1e-9
    # (c) the jitted path evaluates the surrogate (f32 here)
    got = np.asarray(jax.jit(lambda t: qd(t))(jnp.asarray(T, jnp.float32)))
    assert np.max(np.abs(got / exact - 1.0)) < 1e-4
    # (d) analytic models untouched
    cat_folder, _ = write_hc5n_inputs(str(tmp_path), seed=0)
    qa = q_model_for_catalog(load_catalog(
        os.path.join(cat_folder, "hc5n_hfs.cat")))
    assert fit_device_cheb(qa, 3.5, 12.0) is qa
