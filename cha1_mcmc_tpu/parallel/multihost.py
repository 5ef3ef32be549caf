"""Multi-host (DCN) orchestration helpers.

The scaling layout (SURVEY §5/§7): walkers and catalog lines shard across a
host's chips over ICI (parallel/sharded.py); *independent* work — separate
molecules, or independent chains of one molecule — distributes across hosts
over DCN, with no inter-host communication during sampling.

These helpers wire that up with jax.distributed. They cannot be exercised
on this single-host image; they are thin by design (initialization +
deterministic work assignment) so the untestable surface is minimal.
"""

from __future__ import annotations

import jax

__all__ = ["initialize_multihost", "host_molecule_assignment"]


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> tuple[int, int]:
    """Initialize jax.distributed and return (process_index, process_count).

    With no arguments, jax auto-detects cluster environment variables
    (JAX_COORDINATOR_ADDRESS etc.). Call once per process before any other
    JAX operation — including jax.process_count(), which would initialize
    the local backend and break distributed startup, so this function must
    not query it before initializing.
    """
    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    else:
        try:
            # Auto-detect cluster environment (SLURM, Open MPI, ...). On a
            # plain single host with no cluster variables this raises; that
            # is the legitimate single-process case.
            jax.distributed.initialize()
        except Exception:
            pass
    return jax.process_index(), jax.process_count()


def host_molecule_assignment(molecules, process_index: int,
                             process_count: int) -> list:
    """Deterministic round-robin assignment of molecules to hosts —
    the DCN-level data parallelism (independent fits, no collectives)."""
    ordered = sorted(molecules)
    return [m for i, m in enumerate(ordered) if i % process_count == process_index]
