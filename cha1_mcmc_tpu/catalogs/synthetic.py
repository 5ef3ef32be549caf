"""Seeded synthetic inputs: an SPCAT catalog, a DSN-style spectrum and a
dense many-line model, all generated from a seed.

The fits this package runs need a molecular line catalog and an observed
spectrum. For tests, benchmarks and smoke runs on machines without the
reference data tree, this module writes both from physics:

* :func:`linear_rotor_hfs_lines` — a linear rotor with one 14N nucleus
  (I = 1). Rotational levels E = B J(J+1) - D J^2 (J+1)^2, split by the
  first-order electric-quadrupole energy; HFS components J' -> J'-1 with
  Delta F in {0, +-1}, strengths from the Wigner 6j recoupling
  coefficients. Defaults are HC5N (B ~ 1331.33 MHz, eQq ~ -4.3 MHz,
  mu ~ 4.33 D); the values are approximate, not the CDMS fit.
* :func:`write_spcat` — the fixed-width `.cat` layout that
  `catalogs.spcat.parse_spcat` reads, with log-intensities at 300 K
  derived so that the parser's Einstein A reproduces the generated ones.
* :func:`dsn_spectrum` — a `(2, N)` `[freq_MHz, intensity]` spectrum in
  bands around each rotational transition: the LTE model at an injected
  truth (models/forward.py:forward_host, float64) plus Gaussian noise.
* :func:`dense_lines` — a 35,460-line asymmetric-top-like line list over
  0.5-30 GHz (clustered plus smooth), the shape of the reference's dense
  aromatic stress catalog, for the sparse gather path.

`write_hc5n_inputs` is the one-call entry: the HC5N catalog (named
`hc5n_hfs.cat`, so catalogs/partition.py resolves its analytic Q) and the
spectrum, reduced by the unchanged `reduce_spectrum` to the reference
flagship's shape (9 covered lines; tests/test_synthetic.py records the
exact channel count).
"""

from __future__ import annotations

import math
import os

import numpy as np

from cha1_mcmc_tpu.constants import (AIJ_CONST, EUPPER_CONV, SIJMU_CONST,
                                     T_CMB)

__all__ = ["HC5N", "HC5N_TRUTH", "linear_rotor_hfs_lines", "write_spcat",
           "dsn_spectrum", "write_hc5n_inputs", "dense_lines",
           "dense_problem", "DENSE_BOUNDS", "DENSE_TRUTH"]

# Approximate HC5N constants (MHz, MHz, MHz, Debye) and CDMS species tag.
HC5N = dict(B=1331.3327, D=3.01e-5, eQq=-4.3, mu=4.33, tag=75503)
# Injected truth of the flagship spectrum and its observing geometry
# (the Cha-MMS1 HC5N fit: 52" source, 70 m dish, aligned at 4.10 km/s).
HC5N_TRUTH = dict(Ncol=3.2e12, Tex=7.5, vlsr=4.11, dV=0.78,
                  source_size=52.0, dish_size=70.0, aligned_velocity=4.10)
# Dense problem: prior box, injected truth and aligned velocity (the
# TMC-1 source velocity of the GOTHAM aromatic fits).
DENSE_BOUNDS = {"Ncol": (1e8, 1e14), "Tex": (3.5, 12.0),
                "vlsr": (4.0, 7.5), "dV": (0.4, 1.5)}
DENSE_TRUTH = dict(Ncol=1.0e12, Tex=8.0, vlsr=5.8, dV=0.7575)
DENSE_CENTER = 5.8
# Analytic HFS partition function of catalogs/partition.py for 'hc5n_hfs'.
_Q_HC5N_HFS = lambda T: 3.0 * (0.2214 + 15.65419 * T)  # noqa: E731


def _wigner6j(a: int, b: int, c: int, d: int, e: int, f: int) -> float:
    """{a b c; d e f} for integer arguments (Racah's formula)."""
    def tri(x, y, z):
        return (x + y >= z) and (x + z >= y) and (y + z >= x)

    if not (tri(a, b, c) and tri(a, e, f) and tri(d, b, f) and tri(d, e, c)):
        return 0.0
    fact = math.factorial

    def delta(x, y, z):
        return math.sqrt(fact(x + y - z) * fact(x - y + z) * fact(-x + y + z)
                         / fact(x + y + z + 1))

    pre = delta(a, b, c) * delta(a, e, f) * delta(d, b, f) * delta(d, e, c)
    lo = max(a + b + c, a + e + f, d + b + f, d + e + c)
    hi = min(a + b + d + e, b + c + e + f, c + a + f + d)
    total = 0.0
    for t in range(lo, hi + 1):
        total += ((-1) ** t * fact(t + 1)
                  / (fact(t - a - b - c) * fact(t - a - e - f)
                     * fact(t - d - b - f) * fact(t - d - e - c)
                     * fact(a + b + d + e - t) * fact(b + c + e + f - t)
                     * fact(c + a + f + d - t)))
    return pre * total


def _level_energy(J: int, F: int, B: float, D: float, eQq: float) -> float:
    """Rotational + first-order quadrupole energy (MHz) of (J, F), I = 1."""
    e_rot = B * J * (J + 1) - D * (J * (J + 1)) ** 2
    if J == 0:
        return e_rot
    C = F * (F + 1) - 2 - J * (J + 1)
    e_q = eQq * (0.75 * C * (C + 1) - 2 * J * (J + 1)) / (
        2.0 * (2 * J - 1) * (2 * J + 3))
    return e_rot + e_q


def linear_rotor_hfs_lines(j_max: int = 11, *, B=HC5N["B"], D=HC5N["D"],
                           eQq=HC5N["eQq"], mu=HC5N["mu"]) -> dict:
    """HFS line list of a linear rotor with one I = 1 nucleus.

    Every J' -> J'-1 transition for J' = 1..j_max, split into its allowed
    F' -> F'' components (Delta F = 0, +-1): 3 for J' = 1, 6 above, so
    j_max = 11 gives 63 lines. Returns float64/int64 arrays sorted by
    frequency: freq (MHz), elower (cm^-1), aij (s^-1), gup, and the
    quantum numbers (Jup, Fup, Jlow, Flow).
    """
    rows = []
    for Ju in range(1, j_max + 1):
        Jl = Ju - 1
        comps = [(Fu, Fl) for Fu in range(abs(Ju - 1), Ju + 2)
                 for Fl in range(abs(Jl - 1), Jl + 2)
                 if abs(Fu - Fl) <= 1 and not (Fu == 0 and Fl == 0)]
        weights = np.array([(2 * Fu + 1) * (2 * Fl + 1)
                            * _wigner6j(Jl, Fl, 1, Fu, Ju, 1) ** 2
                            for Fu, Fl in comps])
        # Linear-rotor line strength S = J' per rotational line, times the
        # (2I + 1) spin degeneracy the HFS partition function carries.
        s_mu2 = 3.0 * Ju * mu ** 2 * weights / weights.sum()
        for (Fu, Fl), smu in zip(comps, s_mu2):
            if smu <= 0.0:
                continue
            e_up = _level_energy(Ju, Fu, B, D, eQq)
            e_lo = _level_energy(Jl, Fl, B, D, eQq)
            freq = e_up - e_lo
            gup = 2 * Fu + 1
            rows.append((freq, e_lo / EUPPER_CONV,
                         AIJ_CONST * freq ** 3 * smu / gup, gup, smu,
                         Ju, Fu, Jl, Fl))
    rows.sort(key=lambda r: r[0])
    cols = list(zip(*rows))
    return dict(freq=np.array(cols[0]), elower=np.array(cols[1]),
                aij=np.array(cols[2]), gup=np.array(cols[3], dtype=np.int64),
                sijmu=np.array(cols[4]),
                qn_up=np.array([cols[5], cols[6]], dtype=np.int64).T,
                qn_low=np.array([cols[7], cols[8]], dtype=np.int64).T)


def write_spcat(path: str, lines: dict, *, tag: int = HC5N["tag"],
                q_ct=_Q_HC5N_HFS, CT: float = 300.0) -> None:
    """Write `lines` (from linear_rotor_hfs_lines) as an SPCAT `.cat`.

    The 300 K log-intensity inverts parse_spcat's sijmu formula
    (reference classes.py:94-98), so the parsed Einstein A matches the
    generated one up to the 4-decimal log-intensity rounding.
    """
    freq, elower, sijmu = lines["freq"], lines["elower"], lines["sijmu"]
    eupper = elower + freq / EUPPER_CONV
    boltz = np.exp(-(elower / 0.695) / CT) - np.exp(-(eupper / 0.695) / CT)
    logint = np.log10(sijmu * SIJMU_CONST * freq * boltz / q_ct(CT))
    with open(path, "w") as fh:
        for i in range(freq.size):
            (Ju, Fu), (Jl, Fl) = lines["qn_up"][i], lines["qn_low"][i]
            fh.write(f"{freq[i]:13.4f}{0.001:8.4f}{logint[i]:8.4f}{3:2d}"
                     f"{elower[i]:10.4f}{lines['gup'][i]:3d}{tag:7d}{1302:4d}"
                     f"{Ju:2d}{Fu:2d}{'':8s}{Jl:2d}{Fl:2d}\n")


def dsn_spectrum(catalog, *, seed: int = 0, ll: float = 18_000.0,
                 ul: float = 25_000.0, noise: float | None = None,
                 peak_snr: float = 1.5, channel_khz: float = 1.28,
                 band_mhz: float = 2.0, truth: dict = HC5N_TRUTH) -> np.ndarray:
    """DSN-style `(2, N)` `[freq_MHz, intensity]` spectrum of `catalog`.

    Channels of width `channel_khz` in +-`band_mhz` bands around every
    catalog line in (ll, ul]; intensity = the float64 LTE model at `truth`
    (every catalog line in the window, reference inference.py:44-61
    physics) plus Gaussian noise of rms `noise` — by default the injected
    peak over `peak_snr`, below the reduction's 3.5-sigma interloper cut
    (reference inference.py:279), the weak-line regime of the real
    Cha-MMS1 data.
    """
    from cha1_mcmc_tpu.models.forward import forward_host

    i, i2 = catalog.trim_indices(ll, ul)
    centers = catalog.frequency[i:i2]
    step = channel_khz * 1e-3
    grid = np.unique(np.concatenate([
        np.round((c + np.arange(-band_mhz, band_mhz, step)) / step) * step
        for c in centers]))
    sel = np.arange(i, i2)
    model = forward_host(
        (catalog.frequency[sel], catalog.elower[sel], catalog.aij[sel],
         catalog.gup[sel], catalog.glow[sel]),
        _q_for(catalog), grid, vel_offset=truth["aligned_velocity"],
        mask_center=truth["aligned_velocity"], dish_size=truth["dish_size"],
        Tbg=T_CMB, source_size=truth["source_size"], Ncol=truth["Ncol"],
        Tex=truth["Tex"], vlsr=truth["vlsr"], dV=truth["dV"])
    if noise is None:
        noise = float(model.max()) / peak_snr
    rng = np.random.default_rng(seed)
    return np.stack([grid, model + noise * rng.standard_normal(grid.size)])


def _q_for(catalog):
    from cha1_mcmc_tpu.catalogs.partition import q_model_for_catalog

    return q_model_for_catalog(catalog)


def write_hc5n_inputs(directory: str, seed: int = 0) -> tuple[str, str]:
    """Write the flagship inputs into `directory`: `hc5n_hfs.cat` (63
    lines) and `hc5n_dsn_spectrum.npy`. Returns (cat_folder, data_path),
    the FitConfig fields that point at them."""
    from cha1_mcmc_tpu.catalogs import load_catalog

    os.makedirs(directory, exist_ok=True)
    cat_path = os.path.join(directory, "hc5n_hfs.cat")
    write_spcat(cat_path, linear_rotor_hfs_lines())
    data_path = os.path.join(directory, "hc5n_dsn_spectrum.npy")
    np.save(data_path, dsn_spectrum(load_catalog(cat_path), seed=seed))
    return directory, data_path


def dense_lines(seed: int = 0, n_lines: int = 35_460, lo: float = 525.0,
                hi: float = 30_000.0, cluster_frac: float = 0.3,
                cluster_size: int = 40) -> dict:
    """Seeded dense line list shaped like an aromatic asymmetric top.

    Line density rises with frequency; `cluster_frac` of the lines sit in
    tight clusters of ~`cluster_size` within +-0.5 MHz (band heads), so a
    coarse channel grid sees a skewed lines-per-channel distribution (a
    few dozen in the heaviest channels, a few on average). Returns
    float64 freq/elower/aij/gup/glow arrays sorted by frequency.
    """
    rng = np.random.default_rng(seed)
    n_clustered = int(cluster_frac * n_lines)
    n_smooth = n_lines - n_clustered
    smooth = np.sqrt(rng.uniform(lo ** 2, hi ** 2, n_smooth))
    n_clusters = max(n_clustered // cluster_size, 1)
    heads = np.sqrt(rng.uniform(lo ** 2, hi ** 2, n_clusters))
    clustered = (heads[rng.integers(0, n_clusters, n_clustered)]
                 + rng.uniform(-0.5, 0.5, n_clustered))
    freq = np.sort(np.concatenate([smooth, clustered]))
    J = rng.integers(1, 120, n_lines)
    gup = (2 * J + 1).astype(np.float64)
    return dict(freq=freq, elower=rng.exponential(40.0, n_lines),
                aij=10.0 ** rng.uniform(-7.5, -5.0, n_lines) * (freq / 1e4) ** 3,
                gup=gup, glow=gup - 2.0)


def dense_problem(*, n_lines: int = 35_460, n_channels: int = 2048,
                  seed: int = 0) -> dict:
    """Seeded dense single-component problem: `dense_lines` on a uniform
    `n_channels` grid (the reference stress case's 35,460 lines x 2,048
    channels by default), the 1-cyanonaphthalene power-law Q, and a
    spectrum holding the model at DENSE_TRUTH plus noise at 1.5x below
    its peak. Returns a dict of the model, spec, lnprior, ints, yerrs,
    and the float64 host line arrays and channel frequencies that
    forward_host evaluates."""
    from cha1_mcmc_tpu.catalogs.partition import QModel
    from cha1_mcmc_tpu.inference import ParamSpec, single_component_lnprior
    from cha1_mcmc_tpu.models.forward import SpectralModel, forward_host

    d = dense_lines(seed, n_lines=n_lines)
    lines = (d["freq"], d["elower"], d["aij"], d["gup"], d["glow"])
    freqs = np.linspace(d["freq"].min(), d["freq"].max(), n_channels)
    q_model = QModel(kind="analytic", coeffs=(0.0,), power=(560.39, 1.4984))
    model = SpectralModel.from_lines(lines, q_model, freqs, dish_size=100.0,
                                     vel_offset=DENSE_CENTER,
                                     mask_center=DENSE_CENTER)
    signal = forward_host(lines, q_model, freqs, vel_offset=DENSE_CENTER,
                          mask_center=DENSE_CENTER, dish_size=100.0,
                          Tbg=T_CMB, source_size=52.0, **DENSE_TRUTH)
    noise = max(float(signal.max()) / 1.5, 1e-4)
    rng = np.random.default_rng(seed + 1)
    ints = signal + noise * rng.standard_normal(n_channels)
    yerrs = np.full(n_channels, noise)
    spec = ParamSpec(ncomp=1, fixed_source_size=52.0)
    lnprior = single_component_lnprior(
        spec, DENSE_BOUNDS, np.array([3.4e10, 8.0, DENSE_CENTER, 0.7575]),
        np.array([0.34e10, 3.0, 0.06, 0.22]))
    return dict(model=model, spec=spec, lnprior=lnprior, ints=ints,
                yerrs=yerrs, lines=lines, freqs=freqs)
