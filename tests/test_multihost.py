"""Multi-PROCESS execution proof: 2 jax.distributed CPU processes, 8 global
devices, per-rank input files, distributed assembly + halo CG.

This is the missing-from-round-1 evidence that parallel/multihost.py and the
per-rank input mode (triapoissonparallelimpl2.F:225-231) actually run: the
same solver code paths the single-process tests cover, but across a REAL
process boundary with jax.distributed collectives.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from pfemfort_jax.mesh import generate
from pfemfort_jax.mesh.io import write_partitioned


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(prefix: str, mode: str):
    coord = f"127.0.0.1:{_free_port()}"
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", coord, prefix, mode],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "MULTIHOST OK" in outs[0], outs[0][-3000:]
    return outs[0]


def test_two_process_distributed_solve(tmp_path):
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 16)
    prefix = str(tmp_path / "mh")
    write_partitioned(prefix, mesh, 2, dirichlet=dbc, method="slab")
    _run_workers(prefix, "dia")


def test_two_process_unstructured_ell_solve(tmp_path):
    """Scrambled node numbering across 2 REAL processes: the unstructured
    per-shard ELL assembly (all_to_all stash) + pairwise ghost-exchange CG
    must cross the process boundary (each half is also tested
    separately)."""
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 12)
    perm = np.random.default_rng(5).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    prefix = str(tmp_path / "mhu")
    write_partitioned(prefix, mesh, 2, dirichlet=dbc, method="rcb")
    out = _run_workers(prefix, "ell")
    assert "layout=ell" in out, out[-3000:]


def test_partitioned_roundtrip_single_process(tmp_path):
    """Per-rank files -> merge -> solve matches the direct solve."""
    import jax

    from pfemfort_jax.drivers.partitioned import read_partitioned_local
    from pfemfort_jax.drivers.poisson import solve_poisson

    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 8)
    prefix = str(tmp_path / "pp")
    write_partitioned(prefix, mesh, 4, dirichlet=dbc, method="slab")
    mesh2, dbc2 = read_partitioned_local(prefix, range(4))
    assert mesh2.n_node == mesh.n_node
    assert mesh2.n_elem == mesh.n_elem
    res = solve_poisson(mesh2, dbc2, rtol=1e-10)
    ref = solve_poisson(mesh, dbc, rtol=1e-10)
    assert np.allclose(
        np.sort(res.u_full), np.sort(ref.u_full), atol=1e-8)
    u_exact = (mesh2.coords ** 2).sum(axis=1)
    assert np.abs(res.u_full - u_exact).max() < 1e-6
