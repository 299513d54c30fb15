"""CLI driver tests (subprocess-free: call main() in-process on CPU)."""

import os

import numpy as np
import pytest

from pfemfort_jax.drivers.cli import main


@pytest.fixture()
def tet_prefix(tmp_path):
    rc = main(["genmesh", "tet", "0", "1", "3", "0", "1", "3",
               "0", "1", "3", "-o", str(tmp_path / "box")])
    assert rc == 0
    return str(tmp_path / "box")


def test_genmesh_and_poisson_roundtrip(tet_prefix, tmp_path, capsys):
    out = str(tmp_path / "soln.vtk")
    rc = main(["poisson", tet_prefix + "-nodes.dat", tet_prefix + "-elems.dat",
               tet_prefix + "-DirichBC.dat", "-o", out])
    assert rc == 0
    cap = capsys.readouterr().out
    assert "Convergence in" in cap
    assert os.path.exists(out)


def test_cli_tria_poisson(tmp_path, capsys):
    rc = main(["genmesh", "tria", "0", "1", "4", "0", "1", "4",
               "-o", str(tmp_path / "sq")])
    assert rc == 0
    # tria genmesh writes no DirichBC -> make one (all-boundary zeros)
    from pfemfort_jax.mesh import generate, io as mesh_io
    mesh = mesh_io.read_mesh(str(tmp_path / "sq-nodes.dat"),
                             str(tmp_path / "sq-elems.dat"))
    b = generate.boundary_nodes(mesh)
    np.savetxt(str(tmp_path / "sq-DirichBC.dat"),
               np.stack([b + 1, np.ones(len(b)), np.zeros(len(b))], 1))
    rc = main(["poisson", str(tmp_path / "sq-nodes.dat"),
               str(tmp_path / "sq-elems.dat"),
               str(tmp_path / "sq-DirichBC.dat"),
               "--source", "1.0"])
    assert rc == 0


def test_cli_elasticity_reference_mesh(capsys):
    ref = "/root/reference/input/cookmembranetria32"
    if not os.path.exists(ref + "-nodes.dat.gz"):
        pytest.skip("reference mesh missing")
    rc = main(["elasticity", ref + "-nodes.dat", ref + "-elems.dat",
               ref + "-DirichBC.dat", ref + "-ForceBC.dat"])
    assert rc == 0
    assert "Convergence in" in capsys.readouterr().out


def test_cli_explicit_preset(tmp_path, capsys):
    from pfemfort_jax.mesh import generate, io as mesh_io
    mesh = generate.rect_tria(0, 1, 3, 0, 1, 2)
    left = np.nonzero(np.isclose(mesh.coords[:, 0], 0))[0]
    dbc = np.array([[n, d, 0.0] for n in left for d in (0, 1)])
    mesh_io.write_dat(str(tmp_path / "m"), mesh, dirichlet=dbc)
    rc = main(["explicit", str(tmp_path / "m-nodes.dat"),
               str(tmp_path / "m-elems.dat"), str(tmp_path / "m-DirichBC.dat"),
               "--preset", "tria", "--nsteps", "10",
               "--probe", "2", "3",
               "--probe-out", str(tmp_path / "probe.dat")])
    assert rc == 0
    probe = np.loadtxt(str(tmp_path / "probe.dat"))
    assert probe.shape == (10, 5)


def test_cli_partition_and_vtktovtu(tet_prefix, tmp_path, capsys):
    out = str(tmp_path / "part.vtk")
    rc = main(["partition", tet_prefix + "-nodes.dat",
               tet_prefix + "-elems.dat", "--nparts", "4", "-o", out])
    assert rc == 0
    assert "into 4 parts" in capsys.readouterr().out
    vtu = str(tmp_path / "part.vtu")
    rc = main(["vtktovtu", out, vtu])
    assert rc == 0
    assert "<VTKFile" in open(vtu).read()


def test_cli_cfd_cavity(tmp_path, capsys):
    from pfemfort_jax.mesh import generate, io as mesh_io
    from tests.test_cfd import _cavity_bcs
    mesh = generate.rect_tria(0, 1, 6, 0, 1, 6)
    bcs = _cavity_bcs(mesh)
    mesh_io.write_dat(str(tmp_path / "cav"), mesh, dirichlet=bcs)
    out = str(tmp_path / "cav.vtk")
    rc = main(["cfd", str(tmp_path / "cav-nodes.dat"),
               str(tmp_path / "cav-elems.dat"),
               str(tmp_path / "cav-DirichBC.dat"),
               "--nsteps", "30", "-o", out])
    assert rc == 0
    assert "max|div u|" in capsys.readouterr().out
    assert os.path.exists(out)


def test_cli_explicit_vtk_series(tmp_path, capsys):
    from pfemfort_jax.mesh import generate, io as mesh_io
    import numpy as np
    mesh = generate.rect_tria(0, 1, 3, 0, 1, 2)
    left = np.nonzero(np.isclose(mesh.coords[:, 0], 0))[0]
    dbc = np.array([[n, d, 0.0] for n in left for d in (0, 1)])
    mesh_io.write_dat(str(tmp_path / "m"), mesh, dirichlet=dbc)
    rc = main(["explicit", str(tmp_path / "m-nodes.dat"),
               str(tmp_path / "m-elems.dat"), str(tmp_path / "m-DirichBC.dat"),
               "--preset", "tria", "--nsteps", "10",
               "--vtk-every", "5", "-o", str(tmp_path / "soln.vtk")])
    assert rc == 0
    assert os.path.exists(str(tmp_path / "soln-00005.vtk"))
    assert os.path.exists(str(tmp_path / "soln-00010.vtk"))


def test_cli_poisson_solver_matrix(tet_prefix, capsys):
    """The full solver-option matrix the reference switches via its PETSc
    options file: gmres, MatZeroRows full mode + multigrid, refinement."""
    files = [tet_prefix + "-nodes.dat", tet_prefix + "-elems.dat",
             tet_prefix + "-DirichBC.dat"]
    for extra in (["--ksp", "gmres"],
                  ["--bc-mode", "full", "--precond", "mg"],
                  ["--refine"],
                  ["--matrix-free"]):
        rc = main(["poisson", *files, *extra])
        assert rc == 0, extra
        assert "Convergence in" in capsys.readouterr().out


def test_cli_elasticity_sharded(tmp_path, capsys):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    rc = main(["genmesh", "tet", "0", "1", "3", "0", "1", "3",
               "0", "1", "16", "-o", str(tmp_path / "bar")])
    assert rc == 0
    # clamp the base, pull the tip
    from pfemfort_jax.mesh import io as mesh_io
    mesh = mesh_io.read_mesh(str(tmp_path / "bar-nodes.dat"),
                             str(tmp_path / "bar-elems.dat"))
    base = np.nonzero(np.isclose(mesh.coords[:, 2], 0))[0]
    rows = [[n + 1, d + 1, 0.0] for n in base for d in range(3)]
    np.savetxt(str(tmp_path / "bar-DirichBC.dat"), np.asarray(rows))
    tip = int(np.argmax(mesh.coords[:, 2]))
    np.savetxt(str(tmp_path / "bar-ForceBC.dat"),
               np.asarray([[tip + 1, 1, 1.0]]))
    rc = main(["elasticity",
               str(tmp_path / "bar-nodes.dat"),
               str(tmp_path / "bar-elems.dat"),
               str(tmp_path / "bar-DirichBC.dat"),
               str(tmp_path / "bar-ForceBC.dat"),
               "--shards", "4", "--precond", "bjacobi", "--rtol", "1e-9"])
    assert rc == 0
    assert "Convergence in" in capsys.readouterr().out


def test_options_file_pc_type_ilu_routes_ic0(tmp_path):
    """-pc_type ilu in a PETSc options file must reach the IC(0)
    preconditioner (the reference's serial default,
    triapoissonserialimpl1.F:696 + solverpetsc.F options-file parity)."""
    import numpy as np

    from pfemfort_jax.drivers.cli import main as cli_main
    from pfemfort_jax.mesh import generate
    from pfemfort_jax.mesh.io import write_dat

    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    perm = np.random.default_rng(0).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    prefix = str(tmp_path / "m")
    write_dat(prefix, mesh, dirichlet=dbc)
    opts = tmp_path / "opts.dat"
    opts.write_text("-ksp_type cg\n-pc_type ilu\n-ksp_rtol 1e-9\n")
    out = tmp_path / "o.vtk"
    rc = cli_main(["poisson", f"{prefix}-nodes.dat", f"{prefix}-elems.dat",
                   f"{prefix}-DirichBC.dat", "-o", str(out),
                   "--options-file", str(opts)])
    assert rc == 0
    assert out.exists()
