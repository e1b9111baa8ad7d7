"""mgard_tpu_torch's library cache (``utils/cache.py``, ``ops/_build.py``)
on the CPU: no ``nvcc`` runs here, so the kernel build is driven through
a fake compiler that writes the file named after ``-o``.

* The directory is the argument, else ``MGARD_TPU_CACHE_DIR``, else the
  package's ``_build/``; the empty string gives a temporary directory of
  the process, removed at exit; a second call changes nothing.
* A library's file name follows its sources' bytes, its flags and its
  compiler, not their times.
* ``_build`` reads the setting at the first build, not at import and
  not again.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from mgard_tpu_torch.ops import _build
from mgard_tpu_torch.utils import cache

ROOT = Path(__file__).resolve().parents[1]

FAKE_NVCC = """\
import sys
args = sys.argv[1:]
with open(args[args.index("-o") + 1], "w") as f:
    f.write(" ".join(args))
"""


@pytest.fixture
def unset(monkeypatch, tmp_path):
    """No directory chosen yet and no ``MGARD_TPU_CACHE_DIR``; fake kernel
    sources (two ``.cu`` and a ``.cuh``) and a fake ``nvcc`` in the
    compile and link commands."""
    monkeypatch.setattr(_build, "BUILD_DIR", None)
    monkeypatch.delenv("MGARD_TPU_CACHE_DIR", raising=False)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name, text in (("a.cu", "int a;"), ("b.cu", "int b;"),
                       ("c.cuh", "#define C 1")):
        (csrc / name).write_text(text)
    monkeypatch.setattr(_build, "CSRC", csrc)
    script = tmp_path / "fake_nvcc.py"
    script.write_text(FAKE_NVCC)
    monkeypatch.setattr(_build, "compile_command",
                        lambda src, obj: [sys.executable, str(script),
                                          *_build.ARCH_FLAGS,
                                          *_build.NVCC_FLAGS, "-c", "-o",
                                          str(obj), str(src)])
    monkeypatch.setattr(_build, "link_command",
                        lambda out, objs: [sys.executable, str(script),
                                           "-o", str(out),
                                           *map(str, objs)])
    return tmp_path


def test_directory_order(unset, monkeypatch):
    arg, env = unset / "arg", unset / "env"
    monkeypatch.setenv("MGARD_TPU_CACHE_DIR", str(env))
    assert cache.enable_persistent_cache(str(arg)) == str(arg)
    assert _build.BUILD_DIR == arg and arg.is_dir()
    assert cache.enable_persistent_cache() == str(env)
    assert _build.BUILD_DIR == env and env.is_dir()
    monkeypatch.delenv("MGARD_TPU_CACHE_DIR")
    assert cache.enable_persistent_cache() == cache.DEFAULT_CACHE_DIR
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR \
        == ROOT / "mgard_tpu_torch" / "_build"


def test_idempotent(unset):
    path = str(unset / "libs")
    assert cache.enable_persistent_cache(path) == path
    assert cache.enable_persistent_cache(path) == path
    assert _build.BUILD_DIR == Path(path)
    assert cache.enable_persistent_cache("") is None
    private = _build.BUILD_DIR
    assert private.is_dir() and private != Path(path)
    assert cache.enable_persistent_cache("") is None
    assert _build.BUILD_DIR == private


def test_empty_env_disables(unset, monkeypatch):
    monkeypatch.setenv("MGARD_TPU_CACHE_DIR", "")
    assert cache.enable_persistent_cache() is None
    assert _build.BUILD_DIR.is_dir()
    assert _build.BUILD_DIR != _build.DEFAULT_BUILD_DIR
    # an argument still wins over the empty variable
    assert cache.enable_persistent_cache(str(unset / "x")) == str(
        unset / "x")


def test_disabled_process_removes_its_directory(tmp_path):
    """At import nothing is chosen, and a variable set after it is read
    at the first build; with the empty string the build directory is the
    process's own and is gone after it exits."""
    code = (
        "import os, sys\n"
        "from mgard_tpu_torch.ops import _build\n"
        "assert _build.BUILD_DIR is None\n"
        "os.environ['MGARD_TPU_CACHE_DIR'] = ''\n"
        "path = _build.host_library('mgard_lz4')\n"
        "assert path.parent == _build.BUILD_DIR != _build.DEFAULT_BUILD_DIR\n"
        "print(path)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("MGARD_TPU_CACHE_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    path = Path(out.stdout.strip())
    assert path.name.startswith("libmgard_lz4-")
    assert not path.parent.exists()


def test_name_follows_bytes_not_times(unset, monkeypatch):
    cache.enable_persistent_cache(str(unset / "libs"))
    first = _build.library_path()
    assert first.parent == unset / "libs"
    assert first.name.startswith("libmgard_tpu_torch-")
    for f in _build.CSRC.iterdir():
        os.utime(f, (1e9, 1e9))
    assert _build.library_path() == first
    header = _build.CSRC / "c.cuh"
    header.write_text("#define C 2")
    second = _build.library_path()
    assert second != first
    header.write_text("#define C 1")
    assert _build.library_path() == first
    monkeypatch.setattr(_build, "NVCC_FLAGS", ("-O2",))
    assert _build.library_path() != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", ())
    monkeypatch.setattr(_build, "ARCH_FLAGS", ("-arch=sm_80",))
    assert _build.library_path() != first

    native = unset / "native"
    native.mkdir()
    src = native / "mgard_x.cpp"
    src.write_text("int x;")
    monkeypatch.setattr(_build, "NATIVE", native)
    host = _build.host_library_path("mgard_x")
    os.utime(src, (2e9, 2e9))
    assert _build.host_library_path("mgard_x") == host
    src.write_text("int x = 1;")
    assert _build.host_library_path("mgard_x") != host


def _fake_compiler(path: Path, version: str) -> str:
    path.write_text(f"#!/bin/sh\necho '{version}'\n")
    path.chmod(0o755)
    return str(path)


def test_name_follows_the_compiler(unset, monkeypatch):
    """Another compiler (another path, or what ``--version`` prints) gives
    another name, for the kernel library and for a host codec."""
    cache.enable_persistent_cache(str(unset / "libs"))
    names = []
    for stem, version in (("one", "nvcc 12.4"), ("two", "nvcc 12.4"),
                          ("three", "nvcc 12.8")):
        prog = _fake_compiler(unset / stem, version)
        monkeypatch.setattr(_build, "compile_command",
                            lambda src, obj, prog=prog: [prog, "-c", "-o",
                                                         str(obj), str(src)])
        names.append(_build.library_path().name)
    assert len(set(names)) == 3

    native = unset / "native"
    native.mkdir()
    (native / "mgard_x.cpp").write_text("int x;")
    monkeypatch.setattr(_build, "NATIVE", native)
    hosts = []
    for stem, version in (("gxx_a", "g++ 13"), ("gxx_b", "g++ 14")):
        prog = _fake_compiler(unset / stem, version)
        monkeypatch.setattr(_build, "_gxx", lambda prog=prog: prog)
        hosts.append(_build.host_library_path("mgard_x"))
    assert hosts[0] != hosts[1]
    assert hosts[0].name.startswith("libmgard_x-")


def test_setting_read_at_first_build(unset, monkeypatch):
    first, later = unset / "first", unset / "later"
    monkeypatch.setenv("MGARD_TPU_CACHE_DIR", str(first))
    assert _build.BUILD_DIR is None
    out = _build.build()
    assert out.parent == first == _build.BUILD_DIR and out.exists()
    assert out == _build.library_path()
    # no object or temporary file is left beside the library
    assert [p.name for p in first.iterdir()] == [out.name]
    monkeypatch.setenv("MGARD_TPU_CACHE_DIR", str(later))
    assert _build.build().parent == first
    assert not later.exists()


def test_failed_kernel_build_raises(unset, monkeypatch):
    cache.enable_persistent_cache(str(unset / "libs"))
    monkeypatch.setattr(_build, "compile_command",
                        lambda src, obj: [sys.executable, "-c",
                                          "raise SystemExit(1)"])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert not list((unset / "libs").iterdir())
