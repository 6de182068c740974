"""Real multi-process jax.distributed test (2 controller processes x 4
virtual CPU devices each = one 8-device global mesh), exercising
parallel/launch.distributed_session the way a multi-host job would
(replacing the reference's batch job control, src/cntl_q-gcm:8,45).

Asserts cross-process equality of global reductions, agreement with a
single-process run of the same program, and the is_primary() guard on
global I/O.
"""

import json
import os
import socket
import subprocess
import sys

import pytest  # noqa: F401  (fixtures)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "_dist_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_run(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, coord, "2", str(pid), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"

    vals = [json.load(open(tmp_path / f"proc{i}.json")) for i in (0, 1)]

    # both processes observe identical global reductions (ocean-only
    # runner AND the coupled cycle: xforc + both fluids distributed)
    for k in ("po_l2", "po_max", "qo_l2", "sst_sum", "dpioc",
              "cpl_po_l2", "cpl_sst_sum", "cpl_pa_l2", "cpl_ast_sum",
              "cpl_hmixa_max", "ens_po_l2", "ens_spread"):
        assert vals[0][k] == vals[1][k], k

    # the state was genuinely distributed: 4 local shards of 8 devices
    assert vals[0]["n_local_shards"] == 4
    assert vals[1]["n_local_shards"] == 4
    # the ensemble too: each process stores 4 of the 8 members
    assert vals[0]["ens_local_shards"] == 4
    assert vals[1]["ens_local_shards"] == 4

    # is_primary() guard: exactly process 0, exactly one marker
    assert vals[0]["primary"] is True
    assert vals[1]["primary"] is False
    marker = tmp_path / "primary_marker"
    assert marker.exists()
    assert "process 0" in marker.read_text()

    # and the distributed result matches a same-program single-process
    # run (the in-pytest 8-virtual-device world)
    sys.path.insert(0, os.path.join(_REPO, "tests"))
    import _dist_worker as w
    model, st, f = w.build()
    from qgcm_tpu.models.stepper import (make_ocean_only_runner,
                                         make_coupled_runner)
    ref = make_ocean_only_runner(model)(st, f, 12)
    refs = {k: float(v) for k, v in w.scalars(ref).items()}
    cmodel, oc, at = w.build_coupled()
    oc2, at2 = make_coupled_runner(cmodel)(oc, at, 6)
    refs.update({k: float(v) for k, v in
                 w.coupled_scalars(oc2, at2).items()})
    # single-process reference for the multi-host ensemble: the same
    # members (deterministic in the key) through the plain vmapped
    # runner on the in-pytest 8-virtual-device world
    import jax
    import jax.numpy as jnp
    from qgcm_tpu.models.ensemble import (perturbed_ocean_members,
                                          make_ensemble_runner)
    members = perturbed_ocean_members(model, st,
                                      jax.random.PRNGKey(11), 8,
                                      amp=1e-3)
    ens = make_ensemble_runner(model, kind="ocean")(members, f, 12)
    refs["ens_po_l2"] = float(jnp.sum(ens.po ** 2))
    refs["ens_spread"] = float(jnp.sqrt(jnp.mean(
        jnp.square(jnp.std(ens.po, axis=0)))))
    for k in ("po_l2", "po_max", "qo_l2", "sst_sum", "dpioc",
              "cpl_po_l2", "cpl_sst_sum", "cpl_pa_l2", "cpl_ast_sum",
              "cpl_hmixa_max", "ens_po_l2", "ens_spread"):
        assert abs(vals[0][k] - refs[k]) <= 1e-11 * (abs(refs[k]) + 1e-30), k
