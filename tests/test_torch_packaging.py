"""Packaging of the port's CUDA sources: an installed package (not a
checkout) must carry every file its kernels include, and must not build
into the directory that holds it (``site-packages``)."""

import pathlib
import re
import tomllib
from fnmatch import fnmatch

from mvs_gaussian_splatting_tpu_torch import kernels

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = "mvs_gaussian_splatting_tpu_torch"


def test_every_include_is_packaged():
    """Every ``#include "…"`` under ``csrc/`` names a file there that the
    port's package-data patterns ship, as do the sources themselves."""
    with open(ROOT / "pyproject.toml", "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            PACKAGE]
    csrc = ROOT / PACKAGE / "csrc"
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    assert any(p.suffix == ".cu" for p in sources)

    def packaged(path):
        rel = path.relative_to(ROOT / PACKAGE).as_posix()
        return any(fnmatch(rel, pat) for pat in patterns)

    missing = [p.name for p in sources if not packaged(p)]
    included = set()
    for src in sources:
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                               src.read_text(), re.M):
            target = (src.parent / name).resolve()
            assert target.is_file(), f"{src.name} includes missing {name}"
            included.add(target)
            if not packaged(target):
                missing.append(f"{name} (included by {src.name})")
    assert included and not missing, missing


def test_build_dir_outside_an_installed_package(tmp_path, monkeypatch):
    """In a checkout the kernels build into ``build/torch_kernels`` beside
    the package; for an installed package (no ``pyproject.toml`` beside it)
    into the user cache, never into the package's parent."""
    assert kernels.BUILD_DIR == ROOT / "build" / "torch_kernels"
    site = tmp_path / "site-packages"
    pkg = site / PACKAGE
    pkg.mkdir(parents=True)
    cache = tmp_path / "cache"
    monkeypatch.setenv("XDG_CACHE_HOME", str(cache))
    got = kernels.build_dir(pkg)
    assert got == cache / PACKAGE / "torch_kernels"
    assert site not in got.parents
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    got = kernels.build_dir(pkg)
    assert got == tmp_path / "home" / ".cache" / PACKAGE / "torch_kernels"
    assert site not in got.parents


def test_native_source_is_packaged():
    """The C++ COLMAP reader (``native/gsio.cpp``) is in the port's
    package-data, so an installed package can build it."""
    with open(ROOT / "pyproject.toml", "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            PACKAGE]
    sources = sorted((ROOT / PACKAGE / "native").glob("*.cpp"))
    assert [p.name for p in sources] == ["gsio.cpp"]
    for src in sources:
        rel = src.relative_to(ROOT / PACKAGE).as_posix()
        assert any(fnmatch(rel, pat) for pat in patterns), rel


def test_native_builds_outside_an_installed_package(tmp_path, monkeypatch):
    """An installed package (no ``pyproject.toml`` beside it) builds
    ``libgsio.so`` into the user cache, never into ``site-packages``; a
    checkout builds it under ``build/torch_kernels``."""
    import shutil

    from mvs_gaussian_splatting_tpu_torch import native

    assert native.library_path() == (ROOT / "build" / "torch_kernels"
                                     / "native" / "libgsio.so")
    site = tmp_path / "site-packages"
    src = site / PACKAGE / "native" / "gsio.cpp"
    src.parent.mkdir(parents=True)
    shutil.copy(native.SOURCE, src)
    cache = tmp_path / "cache"
    monkeypatch.setenv("XDG_CACHE_HOME", str(cache))
    so = native.library_path(site / PACKAGE)
    assert so == cache / PACKAGE / "torch_kernels" / "native" / "libgsio.so"
    if shutil.which("g++") is None:
        return
    assert native.build(src, so)
    assert so.is_file()
    assert sorted(p.name for p in site.rglob("*")) == [
        "gsio.cpp", PACKAGE, "native"]
