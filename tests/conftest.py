"""Test environment: force the CPU backend with 8 virtual devices so
multi-device sharding is exercised without accelerators (the JAX-idiomatic
substitute for multi-node mocks; see SURVEY.md §4).

Flagship inputs come from the reference data tree when it is mounted, and
otherwise from the seeded generator (catalogs/synthetic.py); tests that
compare against the reference's own code or data keep `requires_reference`.
"""

import os

# Must happen before jax initializes its backends.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

REFERENCE_ROOT = "/root/reference"
CATALOG_DIR = os.path.join(REFERENCE_ROOT, "catalog")
HC5N_CAT = os.path.join(CATALOG_DIR, "hc5n_hfs.cat")
HC5N_DATA = os.path.join(REFERENCE_ROOT, "data", "DSN", "cha_mms1_hc5n_example.npy")
HC9N_GOTHAM = os.path.join(REFERENCE_ROOT, "data", "GOTHAM", "hc9n_hfs_chunks.npy")

requires_reference = pytest.mark.skipif(
    not os.path.isdir(REFERENCE_ROOT), reason="reference tree not mounted")


@pytest.fixture(scope="session")
def hc5n_inputs(tmp_path_factory):
    """(cat_folder, data_path) of the flagship HC5N fit: the reference's
    catalog and DSN spectrum when the tree is mounted, else the seeded
    synthetic pair (same shapes: 63-line catalog, 9 covered lines)."""
    if os.path.isdir(REFERENCE_ROOT):
        return CATALOG_DIR, HC5N_DATA
    from cha1_mcmc_tpu.catalogs.synthetic import write_hc5n_inputs

    return write_hc5n_inputs(str(tmp_path_factory.mktemp("hc5n_inputs")),
                             seed=0)


@pytest.fixture(scope="session")
def hc5n_catalog(hc5n_inputs):
    from cha1_mcmc_tpu.catalogs import load_catalog

    return load_catalog(os.path.join(hc5n_inputs[0], "hc5n_hfs.cat"))


@pytest.fixture(scope="session")
def hc5n_datagrid(hc5n_catalog, hc5n_inputs):
    from cha1_mcmc_tpu.reduce.datagrid import reduce_spectrum

    return reduce_spectrum(
        hc5n_catalog, hc5n_inputs[1], ll=18000, ul=25000,
        aligned_velocity=4.10, dish_size=70, source_size=52.0,
        block_interlopers=True, verbose=False)


@pytest.fixture(scope="session")
def hc9n_problem():
    """(model, spec, grid, means, stds, dv_bound) for the 14-dim
    4-component GOTHAM hc9n_hfs fit (reference TMC1_four_component.py)."""
    import contextlib
    import io

    from cha1_mcmc_tpu.catalogs import load_catalog
    from cha1_mcmc_tpu.models.forward import SpectralModel, simulate_sticks_host
    from cha1_mcmc_tpu.reduce.datagrid import read_spectrum_gotham
    from cha1_mcmc_tpu.inference import ParamSpec
    from cha1_mcmc_tpu.pipeline.multifit import MultiFitConfig

    cfg = MultiFitConfig(mol_name="hc9n_hfs", template_run=True,
                         cat_folder=CATALOG_DIR, data_path=HC9N_GOTHAM)
    catalog = load_catalog(cfg.catfile_path, name=cfg.mol_name)
    C, dV, T, ss = cfg.fiducial
    freq_sim, int_sim, _ = simulate_sticks_host(
        catalog, C=[C], dV=[dV], T=[T], ll=[cfg.lower_limit],
        ul=[cfg.upper_limit], source_size=ss, dish_size=cfg.dish_size)
    data = np.load(HC9N_GOTHAM, allow_pickle=True)
    with contextlib.redirect_stdout(io.StringIO()):
        grid = read_spectrum_gotham(data, freq_sim, int_sim,
                                    block_interlopers=True)
    spec = ParamSpec(ncomp=cfg.ncomp)
    model = SpectralModel.build(
        catalog, grid.covered_trans, grid.freqs, ll=cfg.lower_limit,
        ul=cfg.upper_limit, dish_size=cfg.dish_size, vel_offset=0.0,
        mask_center=cfg.source_velocity)
    return dict(model=model, spec=spec, grid=grid,
                means=np.asarray(cfg.template_means),
                stds=np.asarray(cfg.template_stds),
                perturbation=np.asarray(cfg.perturbation),
                dv_bound=cfg.dv_bound)


@pytest.fixture(scope="session")
def hc5n_problem(hc5n_catalog, hc5n_datagrid):
    """(model, spec, lnprior, lnprob, grid) for the HC5N template config."""
    import jax
    from cha1_mcmc_tpu.models.forward import SpectralModel
    from cha1_mcmc_tpu.inference import (
        ParamSpec, single_component_lnprior, build_lnprob)

    spec = ParamSpec(ncomp=1, fixed_source_size=52.0)
    model = SpectralModel.build(
        hc5n_catalog, hc5n_datagrid.covered_trans, hc5n_datagrid.freqs,
        ll=18000, ul=25000, dish_size=70, vel_offset=4.10, mask_center=4.10)
    bounds = {"source_size": (30.0, 90.0), "Ncol": (1e8, 1e14),
              "Tex": (3.5, 12.0), "vlsr": (3.0, 5.5), "dV": (0.4, 1.5)}
    means = np.array([3.4e10, 8.0, 4.3, 0.7575])
    stds = np.array([0.34e10, 3.0, 0.06, 0.22])
    lnprior = single_component_lnprior(spec, bounds, means, stds)
    lnprob = jax.jit(build_lnprob(
        model, spec, hc5n_datagrid.ints, hc5n_datagrid.yerrs, lnprior))
    return dict(model=model, spec=spec, lnprior=lnprior, lnprob=lnprob,
                grid=hc5n_datagrid, bounds=bounds, means=means, stds=stds)
