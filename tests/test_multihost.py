"""Two-process jax.distributed smoke test for the DCN layer
(cha1_mcmc_tpu/parallel/multihost.py).

Real multi-host hardware is unavailable to the test suite, so the
distributed runtime is exercised the honest way that *is* available: two local
processes on the CPU backend, a coordinator on localhost, and the full
initialize -> global-device-visibility -> disjoint-work-assignment path.
Matches SURVEY §5 "distributed communication backend".
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

from cha1_mcmc_tpu.parallel.multihost import (initialize_multihost,
                                              host_molecule_assignment)

pid, n, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
idx, cnt = initialize_multihost(addr, num_processes=n, process_id=pid)
assert (idx, cnt) == (pid, n), (idx, cnt)
# every process sees the *global* device set over DCN
assert jax.device_count() == 2 * n, jax.device_count()
assert len(jax.local_devices()) == 2

mine = host_molecule_assignment(["hc5n", "hc7n", "hc9n", "benzonitrile",
                                 "cyanonaphthalene"], idx, cnt)
print("ASSIGNED", idx, ",".join(mine), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_smoke():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    addr = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, str(pid), "2", addr],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)

    assigned = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("ASSIGNED"):
                _, idx, mols = line.split(" ", 2)
                assigned[int(idx)] = set(mols.split(","))
    assert set(assigned) == {0, 1}
    # round-robin assignment is disjoint and covering
    assert assigned[0] & assigned[1] == set()
    assert assigned[0] | assigned[1] == {
        "hc5n", "hc7n", "hc9n", "benzonitrile", "cyanonaphthalene"}


def test_assignment_determinism_and_edge_cases():
    """host_molecule_assignment is deterministic, order-insensitive,
    disjoint-covering for every process count, and yields empty lists for
    surplus hosts (more hosts than molecules)."""
    from cha1_mcmc_tpu.parallel.multihost import host_molecule_assignment

    mols = ["hc9n", "hc5n", "benzonitrile", "hc7n", "cyanonaphthalene"]
    for count in (1, 2, 3, 5, 8):
        parts = [host_molecule_assignment(mols, i, count)
                 for i in range(count)]
        # disjoint and covering
        flat = [m for p in parts for m in p]
        assert sorted(flat) == sorted(mols)
        assert len(set(flat)) == len(flat)
        # deterministic and insensitive to input ordering
        shuffled = list(reversed(mols))
        assert parts == [host_molecule_assignment(shuffled, i, count)
                         for i in range(count)]
    # more hosts than molecules: the surplus hosts idle with empty lists
    parts = [host_molecule_assignment(mols, i, 8) for i in range(8)]
    assert sum(1 for p in parts if not p) == 3
    # empty molecule list: every host idles
    assert host_molecule_assignment([], 0, 4) == []


_BATCH_WORKER = """
import os
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

import contextlib
import io

from cha1_mcmc_tpu.parallel.multihost import initialize_multihost
from cha1_mcmc_tpu.pipeline.batch import fit_molecules
from cha1_mcmc_tpu.pipeline.config import FitConfig

pid, n, addr, workdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                         sys.argv[4])
idx, cnt = initialize_multihost(addr, num_processes=n, process_id=pid)

base = FitConfig(
    mol_name="placeholder", nruns=4, nwalkers=8, MLE_for_Ncol=False,
    cat_folder=os.path.join(workdir, "catalog"),
    fit_folder=os.path.join(workdir, "results"),
    checkpoint_every=4, seed=0)
data_paths = {m: sys.argv[5] for m in ("molA", "molB")}
with contextlib.redirect_stdout(io.StringIO()):
    results = fit_molecules(base, data_paths,
                            process_index=idx, process_count=cnt)
for mol, chain in results.items():
    print("FITTED", idx, mol, chain.shape, flush=True)
"""


def test_batch_fit_two_process(tmp_path, hc5n_inputs):
    """The batch-fit path (pipeline/batch.py:fit_molecules) under a real
    2-process jax.distributed cluster: molecules split across processes,
    each runs a full SpectralFit, chain artifacts land on disk."""
    import shutil

    cat_dir = tmp_path / "catalog"
    cat_dir.mkdir()
    cat_folder, data = hc5n_inputs
    for name in ("molA", "molB"):
        shutil.copy(os.path.join(cat_folder, "hc5n_hfs.cat"),
                    cat_dir / f"{name}.cat")

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    addr = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _BATCH_WORKER, str(pid), "2", addr,
             str(tmp_path), data],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for pid in range(2)
    ]
    fitted = {}
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        for line in out.splitlines():
            if line.startswith("FITTED"):
                _, idx, mol, shape = line.split(" ", 3)
                fitted[mol] = (int(idx), shape)
    # both molecules fitted, on different hosts, with the right chain shape
    assert set(fitted) == {"molA", "molB"}
    assert fitted["molA"][0] != fitted["molB"][0]
    assert all(shape == "(8, 4, 4)" for _, shape in fitted.values())
    for name in ("molA", "molB"):
        assert (tmp_path / "results" / name / "chain_template.npy").exists()
