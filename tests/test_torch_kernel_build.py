"""The kernel build cache (tpu_deer_torch.kernels.build): a library's name
carries a hash of its source and of the headers in csrc/, so an edited
header rebuilds every kernel. Runs without nvcc: nothing is compiled."""

import pytest

from tpu_deer_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "shared.cuh"\nint a() { return 1; }\n')
    (src / "b.cu").write_text("int b() { return 2; }\n")
    (src / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return src


def test_target_is_in_the_build_dir_and_stable(csrc):
    target = build._target("a")
    assert target.parent == build.BUILD_DIR
    assert target.name.startswith("liba_") and target.suffix == ".so"
    assert build._target("a") == target


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_target_changes_with_a_header_or_the_source(csrc, edit):
    before = build._target("a")
    if edit == "header":
        (csrc / "shared.cuh").write_text("#pragma once\nconstexpr int k = 1;\n")
    elif edit == "new_header":
        (csrc / "other.cuh").write_text("#pragma once\n")
    else:
        (csrc / "a.cu").write_text('#include "shared.cuh"\nint a() { return 3; }\n')
    assert build._target("a") != before


def test_target_ignores_another_kernels_source(csrc):
    before = build._target("a")
    (csrc / "b.cu").write_text("int b() { return 4; }\n")
    assert build._target("a") == before


def test_built_library_is_reused_without_nvcc(csrc, monkeypatch):
    def no_nvcc():
        raise AssertionError("nvcc must not run for a built library")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    target = build._target("a")
    target.parent.mkdir(parents=True)
    target.write_bytes(b"")
    assert build.build("a") == ""
    (csrc / "shared.cuh").write_text("#pragma once\n// edited\n")
    with pytest.raises(AssertionError, match="nvcc must not run"):
        build.build("a")
