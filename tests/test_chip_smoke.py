"""chip_smoke.py: each phase at a tiny size on the CPU, the refusal to run
without a GPU, and the compile-cache helper the script shares with the CLI.

The phases' full sizes run on the card (`python chip_smoke.py`); here the
same functions check the same things on meshes small enough for CPU tests.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load()

ONE_CARD_TINY = {
    "main": lambda: cs.phase_main(8),
    "cli": lambda: cs.phase_cli(4),
    "unstructured": lambda: cs.phase_unstructured(12),
    "mg": lambda: cs.phase_mg(8),
    "f64": lambda: cs.phase_f64(8),
    "elasticity": lambda: cs.phase_elasticity(2),
    "explicit": lambda: cs.phase_explicit(8, 50),
}

SHARDED_TINY = {
    "sharded_lattice": lambda c: cs.phase_sharded_lattice(c, 12),
    "sharded_unstructured": lambda c: cs.phase_sharded_unstructured(c, 12),
    "sharded_mg": lambda c: cs.phase_sharded_mg(c, 16),
    "sharded_explicit": lambda c: cs.phase_sharded_explicit(c, 3, 40),
}


def test_phase_tables_cover_every_phase():
    assert [n for n, _ in cs.ONE_CARD] == list(ONE_CARD_TINY)
    assert [n for n, _ in cs.SHARDED] == list(SHARDED_TINY)


@pytest.mark.parametrize("name", list(ONE_CARD_TINY))
def test_one_card_phase_tiny(name):
    out = ONE_CARD_TINY[name]()
    assert json.loads(json.dumps(out, default=float))


@pytest.mark.parametrize("name", list(SHARDED_TINY))
def test_sharded_phase_tiny(name):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    out = SHARDED_TINY[name](4)
    assert json.loads(json.dumps(out, default=float))


def test_phase_failure_raises():
    """A phase whose check fails raises; it is never reported as passed."""
    with pytest.raises(AssertionError, match="unstructured/x: boom"):
        cs._check("unstructured/x", False, "boom")


def test_device_check_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as ex:
        cs.main([])
    assert ex.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


def test_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from pfemfort_jax.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from pfemfort_jax.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)

