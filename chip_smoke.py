"""Check that the solver runs, and runs right, on NVIDIA GPUs.

    python chip_smoke.py              # one card: phases 0-7
    python chip_smoke.py --cards 4    # four cards: the sharded path only

One process drives every card.  Each phase runs the system through the entry
points a user calls, checks its answer against an exact solution, a float64
residual or a CPU float64 run, and prints its numbers.  Any failed check ends
the run with a non-zero exit.  The last line of standard output is one JSON
object naming the device:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

The run refuses to start (non-zero exit, no result line) when JAX finds no
GPU: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# Tolerances, each with its reason.
# Nodal error of an f32 solve to rtol 1e-6 of the Poisson problem whose exact
# solution u = x^2 + y^2 + z^2 is nodally exact on these meshes: |u| <= 3, so
# 1e-3 is about 3e-4 relative, which f32 CG to 1e-6 reaches with room for the
# conditioning of a 200^3 box (measured there: 2.3e-4).
NODAL_TOL = 1e-3
# Relative residual target of the float64 paths (the reference's KSP rtol).
F64_RTOL = 1e-8
# Explicit dynamics, f32 on the card against f64 on the CPU: a few hundred
# neutrally stable central-difference steps, each rounding at 6e-8, keep the
# relative difference of the displacement field well below 1e-3.
EXPLICIT_TOL = 1e-3
# Two f32 solves of one problem to rtol 1e-6 (sharded against one card)
# differ by at most the nodal tolerance of each.
AGREE_TOL = 2 * NODAL_TOL
# Sharded explicit dynamics against one card, both f32: the same arithmetic
# with sums taken in another order, so the same bound as f32 against f64.
SHARDED_EXPLICIT_TOL = EXPLICIT_TOL


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as ex:
        return f"unavailable ({type(ex).__name__})"


def device_check(cards: int) -> dict:
    """Phase 0: refuse anything but `cards` GPUs (SystemExit(2) otherwise)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devs[0].platform!r}); refusing to run", file=sys.stderr)
        raise SystemExit(2)
    if len(devs) < cards:
        print(f"chip_smoke: --cards {cards} needs {cards} GPUs, JAX found "
              f"{len(devs)}", file=sys.stderr)
        raise SystemExit(2)
    log(nvidia_smi())           # name, power limit: one line per card
    log(f"device: {devs[0].platform} {devs[0].device_kind} x{len(devs)}; "
        f"jax {jax.__version__}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _peak_bytes() -> int:
    import jax

    return int((jax.devices()[0].memory_stats() or {})
               .get("peak_bytes_in_use", 0))


def _exact(mesh) -> np.ndarray:
    return (mesh.coords ** 2).sum(axis=1)


def _poisson_fn(c):
    from pfemfort_jax.elements.poisson import poisson_element_matrices

    return poisson_element_matrices(c, "tetra4", source=-6.0)


def _scrambled_box(n: int, seed: int):
    """n^3 x 6 tet box with a random node numbering (no lattice census)."""
    from pfemfort_jax.mesh import generate

    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh, dbc


def _check(name: str, ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"{name}: {what}")


def _solved(name: str, res, mesh) -> dict:
    """Common checks of a Poisson solve: converged, nodal error."""
    iters = int(np.asarray(res.stats.iters))
    err = float(np.abs(res.u_full - _exact(mesh)).max())
    _check(name, bool(np.asarray(res.stats.converged)),
           f"did not converge in {iters} iterations")
    _check(name, err <= NODAL_TOL,
           f"nodal error {err:.3e} > {NODAL_TOL} (max |u| = 3)")
    return {"iters": iters, "nodal_err": err}


def phase_main(n: int = 200) -> dict:
    """Phase 1: the reference's flagship, an n^3 x 6 tet Poisson box
    (n = 200: 48M elements, 7.88M dofs), f32 Jacobi-CG to rtol 1e-6 through
    solve_poisson."""
    import jax.numpy as jnp

    from pfemfort_jax.drivers.poisson import solve_poisson
    from pfemfort_jax.mesh import generate

    t0 = time.perf_counter()
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    t_mesh = time.perf_counter() - t0
    res = solve_poisson(mesh, dbc, dtype=jnp.float32, rtol=1e-6)
    out = _solved("main", res, mesh)
    out.update(n_elem=int(mesh.n_elem), n_dof=int(res.u_reduced.shape[0]),
               mesh_s=t_mesh, host_setup_s=res.timings["pattern_s"],
               assemble_s=res.timings["assemble_s"],
               solve_s=res.timings["solve_s"],
               peak_bytes_in_use=_peak_bytes())
    return out


def _read_vtk_solution(path: str):
    with open(path) as f:
        text = f.read()
    m = re.search(r"POINTS\s+(\d+)\s+float", text)
    n_pts = int(m.group(1))
    pts = np.array(text[m.end():].split()[:3 * n_pts],
                   dtype=np.float64).reshape(n_pts, 3)
    m = re.search(r"SCALARS solution float 1\s+LOOKUP_TABLE default", text)
    sol = np.array(text[m.end():].split()[:n_pts], dtype=np.float64)
    return pts, sol


def phase_cli(n: int = 24) -> dict:
    """Phase 2: `genmesh` then `poisson` through the CLI's main(), then the
    written VTK solution against the exact one."""
    from pfemfort_jax.drivers.cli import main as cli_main

    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "box")
        rc = cli_main(["genmesh", "tet", "0", "1", str(n), "0", "1", str(n),
                       "0", "1", str(n), "-o", prefix])
        _check("cli", rc == 0, f"genmesh returned {rc}")
        out = os.path.join(tmp, "soln.vtk")
        t0 = time.perf_counter()
        rc = cli_main(["poisson", prefix + "-nodes.dat",
                       prefix + "-elems.dat", prefix + "-DirichBC.dat",
                       "--rtol", "1e-6", "-o", out])
        t = time.perf_counter() - t0
        _check("cli", rc == 0, f"poisson returned {rc}")
        pts, sol = _read_vtk_solution(out)
    # the VTK writer stores the solution as float32 text
    err = float(np.abs(sol - (pts ** 2).sum(axis=1)).max())
    _check("cli", err <= NODAL_TOL, f"nodal error {err:.3e} > {NODAL_TOL}")
    return {"n_node": int(len(sol)), "nodal_err": err, "poisson_s": t}


def phase_unstructured(n: int = 96) -> dict:
    """Phase 3: a randomly renumbered n^3 x 6 box kept unstructured
    (recover=False: ELL storage, gathered SpMV) with the Jacobi, IC(0) and
    SA-AMG preconditioners."""
    import jax.numpy as jnp

    from pfemfort_jax.drivers.common import solve_implicit

    mesh, dbc = _scrambled_box(n, seed=0)
    out = {}
    for pc in ("jacobi", "ic0", "amg"):
        t0 = time.perf_counter()
        res = solve_implicit(mesh, 1, dbc, _poisson_fn, dtype=jnp.float32,
                             rtol=1e-6, recover=False, precond=pc)
        wall = time.perf_counter() - t0
        r = _solved(f"unstructured/{pc}", res, mesh)
        _check(f"unstructured/{pc}",
               res.timings.get("precond_used") == pc,
               f"fell back to {res.timings.get('precond_used')}")
        out[pc] = dict(r, wall_s=wall, host_setup_s=res.timings["pattern_s"],
                       assemble_s=res.timings["assemble_s"],
                       solve_s=res.timings["solve_s"])
    out["n_dof"] = int(res.u_reduced.shape[0])
    return out


def phase_mg(n: int = 96) -> dict:
    """Phase 4: geometric multigrid CG on the n^3 x 6 lattice."""
    import jax.numpy as jnp

    from pfemfort_jax.drivers.poisson import solve_poisson
    from pfemfort_jax.mesh import generate

    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    t0 = time.perf_counter()
    res = solve_poisson(mesh, dbc, dtype=jnp.float32, rtol=1e-6,
                        bc_mode="full", precond="mg")
    out = _solved("mg", res, mesh)
    out.update(wall_s=time.perf_counter() - t0,
               host_setup_s=res.timings["pattern_s"],
               mg_setup_s=res.timings["mg_setup_s"],
               solve_s=res.timings["solve_s"])
    return out


def _host_relres(mesh, ndof, dbc, element_fn, u_full, force_bc=None):
    """||b - A u|| / ||b|| of the reduced system, assembled in float64 on
    the CPU backend and applied in numpy."""
    import jax
    import jax.numpy as jnp

    from pfemfort_jax.dofs.dofmap import build_dofmap
    from pfemfort_jax.drivers.common import (
        _point_loads, build_reduced_assembler)
    from pfemfort_jax.elements.geometry import to_element_minor
    from pfemfort_jax.sparse.dia import DIAMatrix

    dofmap = build_dofmap(mesh, ndof, dbc)
    cpu = jax.local_devices(backend="cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        assemble, _ = build_reduced_assembler(mesh, ndof, dofmap,
                                              element_fn, jnp.float64)
        A, b = jax.jit(assemble)(
            jax.device_put(to_element_minor(mesh.elem_coords()), cpu))
        b = np.asarray(b, np.float64) + _point_loads(dofmap, force_bc)
        x = np.asarray(u_full, np.float64)[dofmap.assy_for_soln]
        if isinstance(A, DIAMatrix):
            vals = np.asarray(A.vals, np.float64)
            ax = np.zeros_like(x)
            n = len(x)
            for d, o in enumerate(A.offsets):
                lo, hi = max(0, -o), min(n, n - o)
                ax[lo:hi] += vals[d, lo:hi] * x[lo + o:hi + o]
        else:
            cols = np.asarray(A.cols)
            xp = np.concatenate([x, [0.0]])
            ax = (np.asarray(A.vals, np.float64)
                  * xp[np.minimum(cols, len(x))]).sum(axis=1)
    return float(np.linalg.norm(b - ax) / np.linalg.norm(b))


def phase_f64(n: int = 96) -> dict:
    """Phase 5: the refined path to the float64 target rtol 1e-8 on the
    n^3 x 6 lattice, with the residual recomputed on the host in f64."""
    from pfemfort_jax.drivers.poisson import solve_poisson
    from pfemfort_jax.mesh import generate

    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    t0 = time.perf_counter()
    res = solve_poisson(mesh, dbc, rtol=F64_RTOL, refine=True)
    wall = time.perf_counter() - t0
    relres = _host_relres(mesh, 1, dbc, _poisson_fn, res.u_full)
    _check("f64", relres <= F64_RTOL,
           f"host f64 relative residual {relres:.3e} > {F64_RTOL}")
    return {"relres_host_f64": relres,
            "relres_reported": float(np.asarray(res.stats.relres)),
            "inner_iters": int(np.asarray(res.stats.iters)),
            "outer_iters": int(res.timings["outer_iters"]),
            "nodal_err": float(np.abs(res.u_full - _exact(mesh)).max()),
            "wall_s": wall}


def phase_elasticity(nx: int = 16) -> dict:
    """Phase 6: a clamped 3D tet beam (nx x 6nx x nx boxes, ndof = 3) under
    the reference's body force, solved by solve_elasticity to the float64
    target; the residual is recomputed on the host in f64."""
    from pfemfort_jax.drivers.elasticity import solve_elasticity
    from pfemfort_jax.drivers.presets import (
        IMPLICIT_ELASTICITY_E, IMPLICIT_ELASTICITY_NU, TETRA_IMPLICIT_BFORCE)
    from pfemfort_jax.elements.elasticity import dmat_3d, elasticity_stiffness
    from pfemfort_jax.mesh import generate

    mesh, _ = generate.box_tet(0, 1, nx, 0, 6, 6 * nx, 0, 1, nx)
    base = np.nonzero(np.isclose(mesh.coords[:, 1], 0.0))[0]
    dbc = np.array([[v, d, 0.0] for v in base for d in range(3)])
    E, nu, bf = (IMPLICIT_ELASTICITY_E, IMPLICIT_ELASTICITY_NU,
                 TETRA_IMPLICIT_BFORCE)
    t0 = time.perf_counter()
    res = solve_elasticity(mesh, dbc, E, nu, bforce=bf, rtol=F64_RTOL,
                           refine=True)
    wall = time.perf_counter() - t0
    D = dmat_3d(E, nu)
    relres = _host_relres(
        mesh, 3, dbc,
        lambda c: elasticity_stiffness(c, "tetra4", D, bforce=bf),
        res.u_full)
    _check("elasticity", relres <= F64_RTOL,
           f"host f64 relative residual {relres:.3e} > {F64_RTOL}")
    return {"n_dof": int(res.u_reduced.shape[0]), "relres_host_f64": relres,
            "inner_iters": int(np.asarray(res.stats.iters)),
            "tip_disp_x": float(res.u_full.reshape(-1, 3)[:, 0].max()),
            "wall_s": wall}


def _tria_strip(nx: int):
    """The TRIA_EXPLICIT preset's cantilever: a 4 x 1 strip of nx x nx/4
    squares, clamped at x = 0."""
    from pfemfort_jax.mesh import generate

    mesh = generate.rect_tria(0, 4, nx, 0, 1, max(nx // 4, 1))
    left = np.nonzero(np.isclose(mesh.coords[:, 0], 0.0))[0]
    dbc = np.array([[v, d, 0.0] for v in left for d in (0, 1)])
    return mesh, dbc


def phase_explicit(nx: int = 64, nsteps: int = 300) -> dict:
    """Phase 7: `nsteps` central-difference steps of the TRIA_EXPLICIT
    preset on the card (f32) against the same run on the CPU backend in
    float64, in this process."""
    import jax
    import jax.numpy as jnp

    from pfemfort_jax.drivers.presets import TRIA_EXPLICIT as P
    from pfemfort_jax.dynamics.explicit import explicit_dynamics

    mesh, dbc = _tria_strip(nx)

    def bforce(t):
        return jnp.asarray(P.bforce) * jnp.where(t <= P.pulse_t, 1.0, 0.0)

    def run(dtype):
        return explicit_dynamics(mesh, dbc, P.E, P.nu, P.dens, P.dt, nsteps,
                                 bforce_fn=bforce, dtype=dtype)

    t0 = time.perf_counter()
    dev = run(jnp.float32)
    wall = time.perf_counter() - t0
    cpu = jax.local_devices(backend="cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        ref = run(jnp.float64)
    rel = float(np.linalg.norm(np.asarray(dev.disp, np.float64) - ref.disp)
                / np.linalg.norm(ref.disp))
    _check("explicit", np.linalg.norm(ref.disp) > 0, "nothing moved")
    _check("explicit", rel <= EXPLICIT_TOL,
           f"relative displacement difference {rel:.3e} > {EXPLICIT_TOL}")
    return {"n_node": int(mesh.n_node), "steps": nsteps, "rel_diff": rel,
            "wall_s": wall}


# ---------------------------------------------------------------------------
# --cards 4: the sharded path against one card
# ---------------------------------------------------------------------------

def _device_mesh(cards: int):
    import jax

    return jax.sharding.Mesh(np.array(jax.devices()[:cards]), ("shard",))


def _agree(name: str, u_sharded, u_single) -> float:
    d = float(np.abs(np.asarray(u_sharded) - np.asarray(u_single)).max())
    _check(name, d <= AGREE_TOL,
           f"sharded and single-card solutions differ by {d:.3e} > "
           f"{AGREE_TOL}")
    return d


def phase_sharded_lattice(cards: int, n: int = 200) -> dict:
    """The n^3 x 6 box (n = 200: 48M elements) through
    solve_implicit_sharded: per-shard DIA assembly and the halo lattice
    SpMV, against the single-card solve and the exact solution."""
    import jax.numpy as jnp

    from pfemfort_jax.drivers.common import solve_implicit
    from pfemfort_jax.drivers.sharded import solve_implicit_sharded
    from pfemfort_jax.mesh import generate

    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    one = solve_implicit(mesh, 1, dbc, _poisson_fn, dtype=jnp.float32,
                         rtol=1e-6)
    r1 = _solved("sharded_lattice/single", one, mesh)
    res = solve_implicit_sharded(mesh, 1, dbc, _poisson_fn,
                                 device_mesh=_device_mesh(cards),
                                 dtype=jnp.float32, rtol=1e-6,
                                 maxiter=20_000)
    _check("sharded_lattice", res.timings["assembly_layout"] == "dia",
           f"layout {res.timings['assembly_layout']}")
    r = _solved("sharded_lattice", res, mesh)
    return dict(r, single_iters=r1["iters"],
                diff_vs_single=_agree("sharded_lattice", res.u_full,
                                      one.u_full),
                assemble_s=res.timings["assemble_s"],
                solve_s=res.timings["solve_s"],
                single_solve_s=one.timings["solve_s"])


def phase_sharded_unstructured(cards: int, n: int = 48) -> dict:
    """A scrambled n^3 x 6 box through the distributed ELL path with
    block-Jacobi IC(0) and with distributed SA-AMG, each against the
    single-card solve with the same preconditioner class."""
    import jax.numpy as jnp

    from pfemfort_jax.drivers.common import solve_implicit
    from pfemfort_jax.drivers.sharded import solve_implicit_sharded

    mesh, dbc = _scrambled_box(n, seed=1)
    dm = _device_mesh(cards)
    out = {}
    for pc in ("ic0", "amg"):
        one = solve_implicit(mesh, 1, dbc, _poisson_fn, dtype=jnp.float32,
                             rtol=1e-6, recover=False, precond=pc)
        _solved(f"sharded_{pc}/single", one, mesh)
        res = solve_implicit_sharded(mesh, 1, dbc, _poisson_fn,
                                     device_mesh=dm, dtype=jnp.float32,
                                     rtol=1e-6, recover=False, precond=pc)
        name = f"sharded_{pc}"
        _check(name, res.timings["assembly_layout"] == "ell",
               f"layout {res.timings['assembly_layout']}")
        _check(name, res.timings["precond_used"] == pc,
               f"fell back to {res.timings['precond_used']}")
        r = _solved(name, res, mesh)
        out[pc] = dict(r, single_iters=int(np.asarray(one.stats.iters)),
                       diff_vs_single=_agree(name, res.u_full, one.u_full),
                       solve_s=res.timings["solve_s"])
    return out


def phase_sharded_mg(cards: int, n: int = 48) -> dict:
    """Distributed geometric MG against the single-card MG solve."""
    import jax.numpy as jnp

    from pfemfort_jax.drivers.poisson import solve_poisson
    from pfemfort_jax.drivers.sharded import solve_implicit_sharded
    from pfemfort_jax.mesh import generate

    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    one = solve_poisson(mesh, dbc, dtype=jnp.float32, rtol=1e-6,
                        bc_mode="full", precond="mg")
    _solved("sharded_mg/single", one, mesh)
    res = solve_implicit_sharded(mesh, 1, dbc, _poisson_fn,
                                 device_mesh=_device_mesh(cards),
                                 dtype=jnp.float32, rtol=1e-6, precond="mg")
    _check("sharded_mg", res.timings["precond_used"] == "mg",
           f"fell back: {res.timings.get('mg_refused')}")
    r = _solved("sharded_mg", res, mesh)
    return dict(r, single_iters=int(np.asarray(one.stats.iters)),
                diff_vs_single=_agree("sharded_mg", res.u_full, one.u_full))


def phase_sharded_explicit(cards: int, n: int = 8, nsteps: int = 200) -> dict:
    """Slab-sharded explicit dynamics of a clamped 3D tet column against the
    single-card integrator, both f32."""
    import jax.numpy as jnp

    from pfemfort_jax.dynamics.explicit import explicit_dynamics
    from pfemfort_jax.dynamics.sharded import explicit_dynamics_sharded
    from pfemfort_jax.mesh import generate

    mesh, _ = generate.box_tet(0, 1, n, 0, 1, n, 0, 4, 4 * n)
    base = np.nonzero(np.isclose(mesh.coords[:, 2], 0.0))[0]
    dbc = np.array([[v, d, 0.0] for v in base for d in range(3)])
    E, nu, dens, dt = 200.0, 0.3, 10.0, 5e-5
    bf = lambda t: jnp.asarray([1.0, 0.0, 0.0], jnp.float32)
    one = explicit_dynamics(mesh, dbc, E, nu, dens, dt, nsteps,
                            bforce_fn=bf, dtype=jnp.float32)
    res = explicit_dynamics_sharded(mesh, dbc, E, nu, dens, dt, nsteps,
                                    device_mesh=_device_mesh(cards),
                                    bforce_fn=bf, dtype=jnp.float32)
    ref = np.asarray(one.disp, np.float64)
    rel = float(np.linalg.norm(res.disp - ref) / np.linalg.norm(ref))
    _check("sharded_explicit", np.linalg.norm(ref) > 0, "nothing moved")
    _check("sharded_explicit", rel <= SHARDED_EXPLICIT_TOL,
           f"relative difference {rel:.3e} > {SHARDED_EXPLICIT_TOL}")
    return {"n_node": int(mesh.n_node), "steps": nsteps, "rel_diff": rel}


ONE_CARD = (("main", phase_main), ("cli", phase_cli),
            ("unstructured", phase_unstructured), ("mg", phase_mg),
            ("f64", phase_f64), ("elasticity", phase_elasticity),
            ("explicit", phase_explicit))
SHARDED = (("sharded_lattice", phase_sharded_lattice),
           ("sharded_unstructured", phase_sharded_unstructured),
           ("sharded_mg", phase_sharded_mg),
           ("sharded_explicit", phase_sharded_explicit))


def run(phases, cards: int | None = None) -> dict:
    """Run every phase, print its numbers; raise on the first failure."""
    results = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        out = fn(cards) if cards is not None else fn()
        out["phase_s"] = time.perf_counter() - t0
        results[name] = out
        log(f"phase {name}: " + json.dumps(out, default=float))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4 runs the sharded path over four cards, and "
                         "nothing else")
    args = ap.parse_args(argv)

    device = device_check(args.cards)
    from pfemfort_jax import native
    from pfemfort_jax.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    log(f"native host library: {native.ensure_built()} "
        f"({time.perf_counter() - t0:.1f} s)")
    if args.cards == 1:
        run(ONE_CARD)
    else:
        run(SHARDED, cards=args.cards)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
