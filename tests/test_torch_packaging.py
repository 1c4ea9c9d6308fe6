"""Packaging of the port's CUDA sources: an installed package (not a
checkout) must carry every file its kernels include, and must not build
into the directory that holds it (``site-packages``). And the port's MVS
branch, viewer and their CLIs import nothing of JAX."""

import ast
import pathlib
import re
import subprocess
import sys
import tomllib
from fnmatch import fnmatch

import pytest

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


# The MVS branch, the network viewer and their CLIs: torch, numpy, PIL
# and sockets only
NO_JAX_FILES = sorted(
    [p.relative_to(ROOT).as_posix() for d in ("mvs", "viewer")
     for p in (ROOT / PACKAGE / d).glob("*.py")]
    + [f"{PACKAGE}/cli/mvs_train.py", f"{PACKAGE}/cli/view.py"])
BANNED = {"jax", "jaxlib", "flax", "optax", "mvs_gaussian_splatting_tpu"}
# the benches, profiles and entry points (checked inside the test below,
# which keeps this file's count of tests)
TOOLS = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / PACKAGE / "tools").glob("*.py"))


def banned_imports(rel):
    """The imports of ``rel``, at the top or inside a function, that name
    JAX, flax, optax or a module of the JAX package."""
    found = []
    for node in ast.walk(ast.parse((ROOT / rel).read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in BANNED]
    return found


@pytest.mark.parametrize("rel", NO_JAX_FILES)
def test_imports_no_jax(rel):
    """No import, at the top or inside a function, names JAX, flax, optax
    or a module of the JAX package."""
    found = banned_imports(rel)
    assert not found, found


def test_new_modules_import_with_jax_blocked():
    """The modules and the tools name no JAX module in any import, import,
    and their CLIs parse their flags, in a process where importing JAX,
    flax, optax or the JAX package fails; every tool runs on ``cuda``
    unless told otherwise."""
    assert len(TOOLS) >= 10
    found = {rel: banned_imports(rel) for rel in TOOLS}
    assert not any(found.values()), found
    tools = [rel[:-3].replace("/", ".") for rel in TOOLS
             if not rel.endswith("__init__.py")]
    modules = [rel[:-3].replace("/", ".") for rel in NO_JAX_FILES] + tools
    code = (
        "import sys\n"
        f"for name in {sorted(BANNED)!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"from {PACKAGE}.cli import mvs_train, view\n"
        "import contextlib, io\n"
        "clis = [mvs_train, view] + [importlib.import_module(m) for m in "
        f"{tools!r}]\n"
        "for cli in clis:\n"
        "    if not hasattr(cli, 'main'):\n"
        "        continue\n"
        "    text = io.StringIO()\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(text):\n"
        "            cli.main(['--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0\n"
        "    assert cli.__name__.endswith(('view', 'plot_validation')) or "
        "'(default cuda)' in ' '.join(text.getvalue().split()), "
        "cli.__name__\n"
        "assert not any(k.split('.')[0] in "
        f"{sorted(BANNED)!r} and sys.modules[k] is not None "
        "for k in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
