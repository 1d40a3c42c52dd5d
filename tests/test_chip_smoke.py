"""chip_smoke.py refuses to pass anywhere but on a GPU with this checkout."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(script: Path, cwd: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("alone", [False, True], ids=["cpu", "script-alone"])
def test_chip_smoke_fails_without_card_or_checkout(tmp_path, alone):
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    res = _run(script, tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "FAIL" in res.stdout
