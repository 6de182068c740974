"""Device mesh + sharding specifications.

The reference's only parallelism is OpenMP loops over grid rows
(src/Structure:60-85). The equivalent here is 2-D spatial domain
decomposition: fields are sharded (y, x) over a Mesh and the jitted step
runs under GSPMD, which inserts the halo exchanges (collective-permutes)
for the stencils and the all-to-alls for the spectral solves
automatically. Constraint scalars and mode vectors stay
replicated.

Axis names: 'y' then 'x' -- matching the [..., y, x] array convention.
"""

from __future__ import annotations

import math
from typing import Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..state import OceanState, AtmosState, OceanForcing, AtmosForcing


def make_mesh(devices: Sequence[jax.Device] | None = None,
              rows_only: bool = False) -> Mesh:
    """2-D ('y','x') mesh, as square as the device count allows.

    rows_only=True puts every device on the 'y' axis (row-block
    decomposition, the analogue of the reference's OpenMP-over-j
    loops).  Prefer it for CYCLIC configurations: the channel stencils'
    x-wraparound on the odd duplicated-column p-grid makes the
    partitioner fall back to full-row all-gathers when x is sharded
    (measured: 40 gathers/scan-iteration at test scale), while with x
    unsharded the wraparound is local and -- together with
    spectral_variant='a2a' -- the step's loop body compiles to ZERO
    all-gathers.  Channel grids are also wide (nx >> ny), so rows are
    the long-memory axis to split."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    ny = n if rows_only else int(math.sqrt(n))
    while n % ny:
        ny -= 1
    import numpy as np
    return Mesh(np.asarray(devices).reshape(ny, n // ny), ("y", "x"))


def _group_by_process(devices) -> "np.ndarray":
    """(n_processes, local_count) device array, rows ordered by
    process_index. Raises if hosts contribute unequal device counts."""
    import numpy as np
    procs = sorted({d.process_index for d in devices})
    rows = [[d for d in devices if d.process_index == p] for p in procs]
    if any(len(r) != len(rows[0]) for r in rows):
        raise ValueError("unequal local device counts across processes")
    return np.array(rows, dtype=object)


def make_hybrid_mesh(devices: Sequence[jax.Device] | None = None,
                     rows_only: bool = False) -> Mesh:
    """DCN-aware mesh for multi-host runs (SURVEY 5.8: keep the
    transform axis intra-slice): processes (hosts) split the 'y' axis
    and each host's local devices fill 'x'.  The spectral pencil
    transposes' per-axis all_to_all over 'x' (parallel/spectral.py)
    then stays within a host; the network between hosts carries the
    thin y-halo rows and the unavoidable host-crossing share of the
    full transpose.
    rows_only=True stacks local devices on 'y' too (channel configs --
    see make_mesh)."""
    if devices is None:
        devices = jax.devices()
    arr = _group_by_process(devices)
    if rows_only:
        arr = arr.reshape(-1, 1)
    return Mesh(arr, ("y", "x"))


def _field_spec(x) -> P:
    """Spatial fields (>=2 dims, trailing y,x) shard over the mesh;
    small vectors/scalars replicate."""
    if x.ndim >= 3:
        return P(*([None] * (x.ndim - 2) + ["y", "x"]))
    if x.ndim == 2:
        return P("y", "x")
    return P()


def _divisible_spec(mesh: Mesh, x) -> P:
    """Like _field_spec but drops mesh axes that do not divide the dim
    (p-grids are N+1 points; device_put demands exact divisibility).
    NOTE: inside jit, `with_sharding_constraint` on an uneven dim is
    silently DROPPED by this jax version -- the partitioner still
    ceil-shards the scan carry internally, so compute distributes; only program inputs/outputs with uneven dims are
    replicated, a per-chunk (not per-step) cost."""
    spec = _field_spec(x)
    fixed = tuple(
        ax if (ax is None or x.shape[d] % mesh.shape[ax] == 0) else None
        for d, ax in enumerate(spec))
    return P(*fixed)


def shard_tree(tree, mesh: Mesh):
    """Initial device placement (host -> mesh). Non-divisible axes stay
    replicated; the jitted step's sharding constraints then settle the
    layout (GSPMD pads uneven shards)."""
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(
            x, NamedSharding(mesh, _divisible_spec(mesh, x))), tree)


def constrain_tree(tree, mesh: Mesh):
    """In-jit sharding constraints pinning fields to the spatial mesh.
    On uneven (N+1 p-grid) dims the constraint is a no-op in this jax
    version (see _divisible_spec note); it still anchors every evenly
    divisible field, from which the partitioner propagates ceil-block
    shardings through the p-grid ops."""
    return jax.tree_util.tree_map(
        lambda x: jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, _field_spec(x))), tree)


# Aliases used by the driver entry and runners
shard_ocean = shard_tree
shard_atmos = shard_tree
shard_forcing = shard_tree
