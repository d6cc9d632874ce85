"""The build of the port's CUDA kernels (octvr_tpu_torch.utils.build):
one shared library per source group, ``product`` (the remap) and
``tools`` (the MXU-taps probe), each cached by the hash of its own
sources and the flags, so a fault in a tool's source never reaches the
product.  No nvcc is needed: these tests hash and check, they build
nothing."""

import ast
import shutil
from pathlib import Path

import pytest
import torch.utils.cpp_extension

from octvr_tpu_torch.utils import build

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "octvr_tpu_torch"


def test_every_source_in_exactly_one_group():
    grouped = [name for names in build.GROUPS.values() for name in names]
    assert sorted(grouped) == sorted(p.name for p in (PKG / "csrc").glob("*.cu"))
    assert build.GROUPS["product"] == ("remap.cu",) and build.GROUPS["tools"] == ("mxu_taps.cu",)


def test_each_library_hashes_only_its_own_group(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(PKG / "csrc", csrc)
    monkeypatch.setattr(build, "_CSRC", csrc)
    product, tools = build.library_path("product"), build.library_path("tools")
    assert product != tools and product.parent == tools.parent == build.build_dir()
    assert product.name.startswith("liboctvr_product_") and tools.name.startswith("liboctvr_tools_")

    broken = csrc / "mxu_taps.cu"
    broken.write_text(broken.read_text() + "\nthis is not C++\n")
    assert build.library_path("product") == product
    tools_broken = build.library_path("tools")
    assert tools_broken != tools

    changed = csrc / "remap.cu"
    changed.write_text(changed.read_text() + "\n// a comment\n")
    assert build.library_path("product") != product
    assert build.library_path("tools") == tools_broken

    with pytest.raises(ValueError, match="unknown kernel group"):
        build.library_path("all")
    (csrc / "remap.cu").unlink()
    with pytest.raises(RuntimeError, match="missing CUDA sources"):
        build.library_path("product")


def test_load_library_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(torch.utils.cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(build, "_LIBS", {})
    for group in build.GROUPS:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load_library(group)
    assert build._LIBS == {} and not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("module,group", [("cuda_remap", "product"), ("mxu_taps", "tools")])
def test_wrappers_load_their_own_group(module, group):
    """ops/cuda_remap.py loads only ``product``; ops/mxu_taps.py only
    ``tools``: every load_library call names its group literally."""
    tree = ast.parse((PKG / "ops" / f"{module}.py").read_text())
    calls = [
        n for n in ast.walk(tree)
        if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "load_library"
    ]
    assert calls
    for c in calls:
        assert [a.value for a in c.args] == [group] and not c.keywords
