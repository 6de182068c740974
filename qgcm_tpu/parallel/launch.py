"""Multi-host launch helper.

Replaces the reference's batch job-control script (src/cntl_q-gcm:
LSF/qsub, 1 process x 32 OpenMP threads via aprun) with one
controller process per host, joined through
`jax.distributed.initialize`, stepping the same jitted program over the
global mesh. Pass the coordinator address, process count and process
id explicitly (or set JAX_COORDINATOR_ADDRESS etc.): nothing on a
plain GPU host presets them.

Typical multi-host driver:

    from qgcm_tpu.parallel.launch import distributed_session
    from qgcm_tpu.parallel.mesh import make_mesh, shard_tree

    with distributed_session():
        mesh = make_mesh()            # all devices across all hosts
        ocean = shard_tree(ocean, mesh)
        atmos = shard_tree(atmos, mesh)
        run = make_coupled_runner(model, mesh=mesh)
        ...

Each host must execute the SAME program; I/O (snapshots, restart)
should be guarded with `is_primary()` unless writing per-shard files.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def distributed_session(coordinator_address=None, num_processes=None,
                        process_id=None):
    """Initialise (and shut down) the multi-host runtime. A no-op when
    running single-process so the same driver works everywhere."""
    initialized = False
    try:
        if num_processes is not None or coordinator_address is not None \
                or _in_multihost_env():
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id)
            initialized = True
        yield
    finally:
        if initialized:
            jax.distributed.shutdown()


def _in_multihost_env() -> bool:
    import os
    return any(k in os.environ for k in
               ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
                "MEGASCALE_COORDINATOR_ADDRESS"))


def is_primary() -> bool:
    """True on the process that should own global (non-sharded) I/O."""
    return jax.process_index() == 0
