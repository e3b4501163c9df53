"""The port's CUDA build: which library file a source maps to.

``library_path`` names a library by a hash of its source, of every shared
header in ``csrc/`` and of the nvcc flags, so that editing any of them
rebuilds instead of loading a stale library. These tests need no nvcc:
they point ``CSRC`` at a temporary directory and only compute names.
"""
import re

import pytest

from paddle_tpu_torch.ops.cuda import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text(
        '#include "helpers.cuh"\nextern "C" int f() { return H; }\n')
    (tmp_path / "helpers.cuh").write_text("#define H 1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_library_path_is_stable(csrc):
    path = _build.library_path("k")
    assert path == _build.library_path("k")
    assert path.parent == _build.BUILD_DIR
    assert re.fullmatch(r"libk-[0-9a-f]{16}\.so", path.name)


def test_library_path_changes_with_an_included_header(csrc):
    before = _build.library_path("k")
    (csrc / "helpers.cuh").write_text("#define H 2\n")
    assert _build.library_path("k") != before


def test_library_path_changes_with_a_new_header(csrc):
    before = _build.library_path("k")
    (csrc / "more.cuh").write_text("#define M 1\n")
    assert _build.library_path("k") != before


def test_library_path_changes_with_the_source(csrc):
    before = _build.library_path("k")
    (csrc / "k.cu").write_text(
        '#include "helpers.cuh"\nextern "C" int f() { return H + 1; }\n')
    assert _build.library_path("k") != before


def test_library_path_changes_with_the_flags(csrc, monkeypatch):
    before = _build.library_path("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("k") != before


def test_every_source_and_its_headers_lie_in_csrc():
    """Each built source exists, and every header it includes by a quoted
    name is a csrc/*.cuh file, so the hash covers it."""
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    for name in _build.SOURCES:
        text = (_build.CSRC / f"{name}.cu").read_text()
        for inc in re.findall(r'#include "([^"]+)"', text):
            assert inc in headers, (name, inc)


def test_entry_points_match_their_c_signatures():
    """Each kernel variant's C entry point takes what the wrapper's typed
    ctypes signature passes: the pointers, then the ints, the scale, the
    strides and the stream (ctypes would pass a mismatch on silently)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    for (kernel, kind), (source, symbol) in fa._ENTRY.items():
        assert source in _build.SOURCES, (kernel, kind)
        text = (_build.CSRC / f"{source}.cu").read_text()
        m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", text,
                      re.S)
        assert m, (source, symbol)
        types = [p.strip().rsplit(" ", 1)[0] for p in m.group(1).split(",")]
        types = ["void*" if t.endswith("void*") else t for t in types]
        n_ptrs, n_ints, n_strides = fa._ARITY.get((kernel, kind),
                                                  fa._ARITY[kernel])
        assert types == (["void*"] * n_ptrs + ["int"] * n_ints + ["float"]
                         + ["long long"] * n_strides + ["void*"]), symbol
