"""The port imports without jax and the JAX package, and chip_smoke.py refuses
to run without a CUDA card or without the repository beside it."""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "h5py", "pandas", "sklearn", "yaml", "point_cloud_classifier_tpu")


def _run(code_or_args, cwd=REPO, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
    )


def test_every_port_module_and_chip_smoke_import_without_jax():
    code = textwrap.dedent(
        f"""
        import importlib, pkgutil, sys
        blocked = {BLOCKED!r}
        for name in list(sys.modules):
            if name.split(".")[0] in blocked:
                del sys.modules[name]
        for name in blocked:
            sys.modules[name] = None  # any import of it now raises ImportError
        import point_cloud_classifier_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        print(len(names), "modules")
        """
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 12


def test_chip_smoke_fails_without_cuda():
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], cwd=tmp_path, env_extra={"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert "ModuleNotFoundError" in proc.stderr
    assert '"ok": true' not in proc.stdout
