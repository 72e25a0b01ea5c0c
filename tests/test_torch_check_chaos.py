"""The port's chaos smoke (``python -m repro_torch.obs.check_chaos``) on
the CPU: every fault class of the repo's ``scripts/check_chaos.py``, and
only those, prints PASS, and the script exits 0 with no fault left armed.
"""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.obs import check_chaos

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCRIPT = os.path.join(ROOT, "scripts", "check_chaos.py")


def test_the_classes_are_the_scripts():
    with open(SCRIPT) as f:
        want = re.findall(r'^\s*check\("([a-z_]+)"', f.read(), re.M)
    assert tuple(want) == check_chaos.CLASSES


def test_every_class_passes_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.obs.check_chaos",
                        "--device", "cpu"], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    lines = p.stdout.splitlines()
    for name in check_chaos.CLASSES:
        assert any(line.startswith(f"PASS chaos/{name}:") for line in lines), \
            p.stdout
    assert not any(line.startswith("FAIL") for line in lines)
    assert lines[-1].startswith(f"chaos smoke OK: {len(check_chaos.CLASSES)}")
