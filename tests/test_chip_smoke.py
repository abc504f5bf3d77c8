"""CPU rehearsal of chip_smoke.py: every phase but the device check, at a
tiny size, must pass its own checks here before it runs on the card."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


@pytest.mark.parametrize("phase", sorted(cs.PHASES))
def test_phase_tiny(phase):
    rep = cs.Report()
    name, fn = cs.PHASES[phase]
    cs._run(rep, f"{phase} {name}", fn, cs.TINY)
    assert rep.failed == []


def test_mesh_phase_tiny():
    rep = cs.Report()
    cs._run(rep, "mesh", cs.phase_mesh, cs.TINY, 4)
    assert rep.failed == []


def test_smoke_refuses_outside_a_checkout(tmp_path, capsys):
    """Copied alone into a directory, the script exits non-zero and prints
    no result."""
    import shutil
    import subprocess
    dst = tmp_path / "chip_smoke.py"
    shutil.copy(cs.__file__, dst)
    r = subprocess.run([sys.executable, str(dst)], capture_output=True,
                       text=True, cwd=tmp_path, timeout=120,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_smoke_refuses_without_gpu():
    """With only CPU devices the script exits non-zero before any phase
    and prints no result."""
    import subprocess
    r = subprocess.run([sys.executable, cs.__file__, "--phases", "6"],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 1, r.stderr[-2000:]
    assert '"ok"' not in r.stdout and "no GPU" in r.stderr
