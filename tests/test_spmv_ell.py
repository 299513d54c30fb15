"""The gathered ELL SpMV against a dense matrix, over the sparsity patterns
the solver meets and the preconditioners' square and rectangular blocks."""

import jax.numpy as jnp
import numpy as np
import pytest

from pfemfort_jax.assembly.pattern import build_pattern
from pfemfort_jax.dofs.dofmap import build_dofmap
from pfemfort_jax.mesh import generate
from pfemfort_jax.mesh.core import Mesh
from pfemfort_jax.solve.amg_device import build_device_ell
from pfemfort_jax.sparse.formats import ELLMatrix
from pfemfort_jax.sparse.spmv import spmv_ell


def _random_cols(rng, n=300, k=7):
    """Unordered random columns, some slots empty (sentinel n)."""
    cols = rng.integers(0, n, (n, k))
    cols[rng.random((n, k)) < 0.2] = n
    return cols, n


def _banded_cols(rng, n=400, half=5):
    cols = np.arange(n)[:, None] + np.arange(-half, half + 1)[None, :]
    return np.where((cols >= 0) & (cols < n), cols, n), n


def _mesh_cols(mesh, dbc):
    dofmap = build_dofmap(mesh, 1, dbc)
    pattern = build_pattern(dofmap.elem_dof, dofmap.total_dof, layout="ell")
    return np.asarray(pattern.ell_cols), pattern.n_rows


def _scrambled_lattice_cols(rng):
    mesh, dbc = generate.box_tet(0, 1, 5, 0, 1, 5, 0, 1, 5)
    perm = rng.permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return _mesh_cols(mesh, dbc)


def _delaunay_cols(rng, n=5):
    """A jittered-point Delaunay tet mesh: no lattice structure at all."""
    from scipy.spatial import Delaunay

    g = np.linspace(0, 1, n + 1)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    inner = ((pts > 1e-9) & (pts < 1 - 1e-9)).all(axis=1)
    pts[inner] += rng.uniform(-0.25, 0.25, (int(inner.sum()), 3)) / n
    tri = Delaunay(pts)
    conn = tri.simplices.astype(np.int64)
    a, b, c, d = (pts[conn[:, i]] for i in range(4))
    vol6 = np.einsum("ij,ij->i", np.cross(b - a, c - a), d - a)
    conn[vol6 < 0] = conn[vol6 < 0][:, [0, 2, 1, 3]]
    conn = conn[np.abs(vol6) > 1e-12]
    mesh = Mesh("tetra4", pts, conn.astype(np.int32))
    hull = np.unique(tri.convex_hull)
    dbc = np.stack([hull, np.zeros(len(hull)), np.zeros(len(hull))], axis=1)
    return _mesh_cols(mesh, dbc)


PATTERNS = {"random": _random_cols, "banded": _banded_cols,
            "scrambled_lattice": _scrambled_lattice_cols,
            "delaunay": _delaunay_cols}


def _dense(cols, vals, n_rows, n_cols):
    A = np.zeros((n_rows, n_cols))
    r, k = np.nonzero(cols < n_cols)
    np.add.at(A, (r, cols[r, k]), vals[r, k])
    return A


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_spmv_ell_matches_dense(pattern, dtype):
    rng = np.random.default_rng(sorted(PATTERNS).index(pattern))
    cols, n = PATTERNS[pattern](rng)
    vals = rng.standard_normal(cols.shape)
    x = rng.standard_normal(n)
    y_ref = _dense(cols, vals, n, n) @ x
    A = ELLMatrix(cols=jnp.asarray(cols, jnp.int32),
                  vals=jnp.asarray(vals.astype(dtype)), n_cols=n)
    y = spmv_ell(A, jnp.asarray(x.astype(dtype)))
    assert y.dtype == dtype and y.shape == (n,)
    y = np.asarray(y, np.float64)
    # rounding of a K-term sum of products in the working precision
    tol = 50 * np.finfo(dtype).eps * np.abs(_dense(cols, np.abs(vals), n, n)
                                            @ np.abs(x)).max()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=tol)


def _square_block(rng):
    cols, n = _banded_cols(rng, n=120, half=3)
    return cols, n, n


def _p0_block(rng, n_f=120, n_c=30):
    """Tentative prolongator shape: one aggregate column per fine row."""
    cols = rng.integers(0, n_c, (n_f, 1))
    return cols, n_f, n_c


def _p0t_block(rng, n_f=120, n_c=30):
    """Its transpose: each coarse row lists its aggregate's fine rows."""
    agg = rng.integers(0, n_c, n_f)
    k = int(np.bincount(agg, minlength=n_c).max())
    cols = np.full((n_c, k), n_f)
    for c in range(n_c):
        members = np.nonzero(agg == c)[0]
        cols[c, :len(members)] = members
    return cols, n_c, n_f


@pytest.mark.parametrize("block", ["square", "p0", "p0t"])
def test_device_ell_block_matches_dense(block):
    rng = np.random.default_rng(7)
    cols, n_rows, n_cols = {"square": _square_block, "p0": _p0_block,
                            "p0t": _p0t_block}[block](rng)
    vals = rng.standard_normal(cols.shape)
    d = build_device_ell(cols, vals, n_cols=n_cols, dtype=jnp.float64)
    assert (d.n_rows, d.n_cols) == (n_rows, n_cols)
    x = rng.standard_normal(n_cols)
    y = np.asarray(spmv_ell(d, jnp.asarray(x)))
    np.testing.assert_allclose(y, _dense(cols, vals, n_rows, n_cols) @ x,
                               rtol=1e-12, atol=1e-12)
