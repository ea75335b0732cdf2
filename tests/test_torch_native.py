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


def test_every_nvcc_call_gets_the_flags_extra_ones_included(fake_nvcc):
    """The flags ``_build`` is given reach every compile and the link: with
    ``PHASE_CLOCKS_FLAG`` the sliced K1 and K2 are built with their per-phase
    clocks."""
    flags = (*native.NVCC_FLAGS, native.PHASE_CLOCKS_FLAG)
    native._build(_sources(fake_nvcc, "a.cu", "b.cu"), fake_nvcc / "build" / "libk.so", flags)
    calls = (fake_nvcc / "calls.log").read_text().splitlines()
    assert len(calls) == 3
    for call in calls:
        assert "arch=compute_90a,code=sm_90a" in call and "-std=c++17" in call
        assert "-DPCC_PHASE_CLOCKS" in call


def test_phase_clocks_are_asked_for_in_code_and_not_by_the_environment(fake_nvcc, monkeypatch):
    """``enable_phase_clocks()`` adds the one flag to the build and to the
    library's name; no environment variable reaches nvcc's command line."""
    monkeypatch.setenv("PCC_NVCC_FLAGS", "-lineinfo")
    monkeypatch.setattr(native, "_phase_clocks", False)
    built = []

    class Stop(Exception):
        pass

    def record(sources, target, flags):
        built.append((target.name, flags))
        raise Stop

    monkeypatch.setattr(native, "_build", record)
    for enable in (False, True):
        native.kernel_library.cache_clear()
        if enable:
            native.enable_phase_clocks()
        with pytest.raises(Stop):
            native.kernel_library()
    native.kernel_library.cache_clear()
    (plain_name, plain_flags), (clock_name, clock_flags) = built
    assert plain_flags == native.NVCC_FLAGS and "-lineinfo" not in plain_flags
    assert clock_flags == (*native.NVCC_FLAGS, native.PHASE_CLOCKS_FLAG)
    assert plain_name != clock_name


def test_build_raises_on_a_failed_compile(fake_nvcc):
    sources = _sources(fake_nvcc, "a.cu", "bad.cu")
    target = fake_nvcc / "build" / "libk.so"
    with pytest.raises(RuntimeError, match="no kernel"):
        native._build(sources, target)
    assert os.listdir(target.parent) == []


def test_every_declared_entry_has_a_definition_in_csrc():
    """Each C entry the loader declares is defined, ``extern "C"``, in exactly
    one source under ``csrc/``, and the graph kernels share one slot rule."""
    import ctypes
    import re

    class Recorder:
        def __getattr__(self, name):
            self.__dict__.setdefault("seen", {})[name] = fn = ctypes.CFUNCTYPE(None)
            return fn

    lib = Recorder()
    native._declare(lib)
    text = {p.name: p.read_text() for p in native.CSRC_DIR.glob("*.cu")}
    assert {"gat_attention_bwd.cu", "inrow_aggregate.cu"} <= set(text)
    for entry in lib.seen:
        homes = [n for n, t in text.items() if re.search(rf"^(int|const char\*) {entry}\(", t, re.M)]
        assert len(homes) == 1, (entry, homes)
    for name in ("gat_attention.cu", "gat_attention_bwd.cu"):
        assert '#include "graph_rows.cuh"' in text[name] and "attention_slots(" in text[name]
