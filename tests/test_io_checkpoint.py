"""Partitioned per-rank I/O (impl2 parity), checkpoint/resume, config."""

import jax.numpy as jnp
import numpy as np
import pytest

from pfemfort_jax.config import SolverOptions
from pfemfort_jax.dynamics.checkpoint import (
    ExplicitState,
    load_state,
    save_state,
)
from pfemfort_jax.dynamics.explicit import explicit_dynamics
from pfemfort_jax.mesh import generate
from pfemfort_jax.mesh import io as mesh_io


def test_partitioned_io_roundtrip(tmp_path):
    mesh, dbc = generate.box_tet(0, 1, 3, 0, 1, 3, 0, 2, 6)
    prefix = str(tmp_path / "part")
    part = mesh_io.write_partitioned(prefix, mesh, 3, dirichlet=dbc)
    assert set(np.unique(part)) == {0, 1, 2}

    total_elems = 0
    for k in range(3):
        sub, dbc_k, gids = mesh_io.read_partitioned(prefix, k)
        total_elems += sub.n_elem
        # local coords equal global coords at gids
        assert np.allclose(sub.coords, mesh.coords[gids], atol=1e-8)
        # connectivity maps back to the global mesh
        gl_conn = gids[sub.conn]
        els = np.nonzero(part == k)[0]
        assert (np.sort(gl_conn, axis=None)
                == np.sort(mesh.conn[els], axis=None)).all()
        # local dbc values match global
        if len(dbc_k):
            gn = gids[dbc_k[:, 0].astype(np.int64)]
            glob = {(int(r[0]), int(r[1])): r[2] for r in dbc}
            for (n, d, v), g in zip(dbc_k, gn):
                assert abs(glob[(int(g), int(d))] - v) < 1e-8
    assert total_elems == mesh.n_elem


def test_explicit_checkpoint_resume(tmp_path):
    mesh = generate.rect_tria(0, 1, 3, 0, 1, 3)
    left = np.nonzero(np.isclose(mesh.coords[:, 0], 0))[0]
    dbc = np.array([[n, d, 0.0] for n in left for d in (0, 1)])
    bf = lambda t: jnp.asarray([1.0, 0.0])
    kw = dict(bforce_fn=bf)
    E, nu, dens, dt = 200.0, 0.3, 10.0, 1e-4

    full = explicit_dynamics(mesh, dbc, E, nu, dens, dt, 40, **kw)

    first = explicit_dynamics(mesh, dbc, E, nu, dens, dt, 25, **kw)
    path = str(tmp_path / "state.npz")
    save_state(path, ExplicitState(disp=first.disp,
                                   disp_prev=first.disp_prev,
                                   velo=first.velo, step=25))
    state = load_state(path)
    rest = explicit_dynamics(mesh, dbc, E, nu, dens, dt, 15,
                             init_state=state, **kw)
    assert np.allclose(rest.disp, full.disp, rtol=1e-12, atol=1e-15)
    assert np.allclose(rest.velo, full.velo, rtol=1e-12, atol=1e-15)


def test_solver_options_parse():
    o = SolverOptions.from_options(
        """# PETSc-style options
        -ksp_type bcgs
        -pc_type bjacobi
        -ksp_rtol 1e-10
        -ksp_max_it 500
        -ksp_gmres_restart 45
        -unknown_flag whatever
        -pfem_refine
        """)
    assert o.ksp_type == "bicgstab"
    assert o.pc_type == "block_jacobi"
    assert o.rtol == 1e-10
    assert o.max_it == 500
    assert o.gmres_restart == 45
    assert o.refine


def test_cli_options_file(tmp_path, capsys):
    mesh, dbc = generate.box_tet(0, 1, 3, 0, 1, 3, 0, 1, 3)
    prefix = str(tmp_path / "m")
    mesh_io.write_dat(prefix, mesh, dirichlet=dbc)
    opts = tmp_path / "petsc_options.dat"
    opts.write_text("-ksp_type cg\n-ksp_rtol 1e-6\n")
    from pfemfort_jax.drivers.cli import main
    rc = main(["poisson", prefix + "-nodes.dat", prefix + "-elems.dat",
               prefix + "-DirichBC.dat", "--options-file", str(opts)])
    assert rc == 0
    assert "Convergence in" in capsys.readouterr().out
