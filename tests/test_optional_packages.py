"""The fit path runs without tqdm and matplotlib: a plain progress line
replaces the bar, and the corner plot is skipped with a note while the
summary table still prints."""

import sys

import numpy as np


def test_progress_without_tqdm(monkeypatch, capsys):
    from cha1_mcmc_tpu.sampler import stretch

    monkeypatch.setitem(sys.modules, "tqdm", None)  # import raises
    bar = stretch._progress(10)
    bar.update(4)
    bar.update(6)
    bar.close()
    assert capsys.readouterr().out.splitlines() == [
        "MCMC sampling: 4/10 steps", "MCMC sampling: 10/10 steps"]


def test_sampler_runs_without_tqdm(monkeypatch, capsys, tmp_path):
    import jax
    import jax.numpy as jnp

    from cha1_mcmc_tpu.sampler import EnsembleSampler

    monkeypatch.setitem(sys.modules, "tqdm", None)
    sampler = EnsembleSampler(lnprob_fn=lambda x: -0.5 * jnp.sum(x * x),
                              nwalkers=8, ndim=2)
    pos0 = np.random.default_rng(0).standard_normal((8, 2))
    sampler.run_mcmc(pos0, 20, jax.random.PRNGKey(0), checkpoint_every=10,
                     chain_file=str(tmp_path / "chain.npy"), progress=True)
    assert sampler.chain.shape == (8, 20, 2)
    assert "MCMC sampling: 20/20 steps" in capsys.readouterr().out


def test_plot_results_without_matplotlib(monkeypatch, capsys, tmp_path):
    from cha1_mcmc_tpu.pipeline.plotting import plot_results

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    chain = np.random.default_rng(0).normal(
        [1.0, 2.0], 0.1, size=(8, 50, 2))
    path = str(tmp_path / "chain_template.npy")
    np.save(path, chain)
    plot_results(path, ["alpha_param", "beta_param"])
    out = capsys.readouterr().out
    assert "matplotlib is not installed" in out
    assert not (tmp_path / "chain_template_corner.png").exists()
    # the summary table still prints
    assert "alpha_param" in out and "beta_param" in out
