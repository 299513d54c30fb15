"""Test configuration: an 8-device virtual CPU mesh + float64.

Multi-chip sharding is exercised on fake devices via
XLA_FLAGS=--xla_force_host_platform_device_count (SURVEY §4), and float64
matches the reference's double-precision semantics for golden comparisons.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Persistent compile cache: the suite's slow tail is XLA CPU compiles of the
# big structured-assembly/multigrid graphs (e.g. the ndof=3 GMG test spends
# ~100 s compiling and <5 s solving).  Caching makes every rerun start from
# the second-run cost.
from pfemfort_jax.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_INPUT = "/root/reference/input"


def has_reference_mesh(prefix: str, parts=("nodes", "elems", "DirichBC")) -> bool:
    import os.path as p
    return all(
        p.exists(f"{REFERENCE_INPUT}/{prefix}-{part}.dat")
        or p.exists(f"{REFERENCE_INPUT}/{prefix}-{part}.dat.gz")
        for part in parts
    )


@pytest.fixture(scope="session")
def tria20x20():
    from pfemfort_jax.mesh import io as mesh_io
    if not has_reference_mesh("tria20x20"):
        pytest.skip("reference tria20x20 mesh not available")
    return mesh_io.read_problem(f"{REFERENCE_INPUT}/tria20x20")


@pytest.fixture(scope="session")
def cookmembrane():
    from pfemfort_jax.mesh import io as mesh_io
    if not has_reference_mesh("cookmembranetria32"):
        pytest.skip("reference cookmembranetria32 mesh not available")
    return mesh_io.read_problem(
        f"{REFERENCE_INPUT}/cookmembranetria32", with_force=True)


@pytest.fixture(scope="session")
def tet10():
    from pfemfort_jax.mesh import io as mesh_io
    if not has_reference_mesh("tet10"):
        pytest.skip("reference tet10 mesh not available")
    return mesh_io.read_problem(f"{REFERENCE_INPUT}/tet10")


@pytest.fixture(scope="session")
def beam3d():
    from pfemfort_jax.mesh import io as mesh_io
    if not has_reference_mesh("beam3Dtet6366"):
        pytest.skip("reference beam3Dtet6366 mesh not available")
    return mesh_io.read_problem(
        f"{REFERENCE_INPUT}/beam3Dtet6366", with_force=True)


def dense_assemble(mesh, dofmap, Ke, Fe=None):
    """Independent, slow dense assembly used as the oracle in tests."""
    n = dofmap.total_dof
    A = np.zeros((n, n))
    b = np.zeros(n)
    ed = dofmap.elem_dof
    ubc = dofmap.bc_values_full[dofmap.elem_nodedof]
    ns = ed.shape[1]
    for e in range(mesh.n_elem):
        for i in range(ns):
            r = ed[e, i]
            if r < 0:
                continue
            if Fe is not None:
                b[r] += Fe[e, i]
            for j in range(ns):
                c = ed[e, j]
                if c >= 0:
                    A[r, c] += Ke[e, i, j]
                else:
                    b[r] -= Ke[e, i, j] * ubc[e, j]
    return A, b


def _build_native_lib():
    """Build the native C++ library at conftest IMPORT time (before test
    modules are collected — test_native.py's skipif is evaluated at import,
    so a session fixture would build too late) so the native tests run and
    `dual_graph`/partitioning route through it (skipped native tests would
    leave the runtime silently on the O(pairs) python fallback)."""
    import subprocess

    from pfemfort_jax import native

    if not native.available():
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        # xdist workers build concurrently on a cold checkout — serialize
        lock_path = os.path.join(root, ".native_build.lock")
        import fcntl
        with open(lock_path, "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                if not native.available():
                    subprocess.run(
                        ["make", "-C",
                         os.path.join(root, "pfemfort_jax", "native")],
                        check=False, capture_output=True)
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)


_build_native_lib()
