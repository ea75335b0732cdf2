"""The port's kernel build: one nvcc per source, all started together, then a
link; a failed compile raises with nvcc's message and leaves no library.

A stand-in ``nvcc`` (a shell script that writes its ``-o`` file) takes the
compiler's place, so this runs without the CUDA toolkit.
"""

import os
import stat

import pytest

pytest.importorskip("torch")

from point_cloud_classifier_tpu_torch import native  # noqa: E402

FAKE_NVCC = """#!/bin/sh
echo "$*" >> "$(dirname "$0")/calls.log"
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
case "$*" in *bad.cu*) echo "bad.cu(1): error: no kernel" >&2; exit 2;; esac
echo built > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(native, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def _sources(tmp_path, *names):
    paths = []
    for name in names:
        (tmp_path / name).write_text("// a kernel\n")
        paths.append(tmp_path / name)
    return paths


def test_build_compiles_each_source_then_links(fake_nvcc):
    sources = _sources(fake_nvcc, "a.cu", "b.cu")
    target = fake_nvcc / "build" / "libk.so"
    native._build(sources, target)
    assert target.read_text() == "built\n"
    calls = (fake_nvcc / "calls.log").read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    assert len(compiles) == 2 and all(" -shared " not in c for c in compiles)
    assert calls[-1].count(".o") == 2 and " -shared " in calls[-1]
    assert sorted(os.listdir(target.parent)) == ["libk.so"]  # objects removed


def test_build_raises_on_a_failed_compile(fake_nvcc):
    sources = _sources(fake_nvcc, "a.cu", "bad.cu")
    target = fake_nvcc / "build" / "libk.so"
    with pytest.raises(RuntimeError, match="no kernel"):
        native._build(sources, target)
    assert os.listdir(target.parent) == []
