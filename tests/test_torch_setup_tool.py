"""The port's setup tool (`tpu_deer_torch/setup_tool.py`) on the CPU, after
tests/test_aux.py::TestSetupTool: the dependency check, the 5 directories
and 2 configs (their YAML equal to the reference's), the install
self-test, and `main`'s skips where a step's package is missing."""

import os

import yaml

from tpu_deer import setup_tool as ref
from tpu_deer_torch import setup_tool


def test_dependency_check():
    status = setup_tool.check_dependencies(verbose=False)
    assert status["torch"] and status["numpy"] and status["scipy"]
    assert set(setup_tool.REQUIRED) <= set(status)
    assert not {"jax", "flax", "optax"} & set(setup_tool.REQUIRED)


def test_scaffold_and_configs_equal_reference(tmp_path):
    ours, theirs = tmp_path / "port", tmp_path / "ref"
    created = setup_tool.setup_project_structure(str(ours))
    assert len(created) == 5
    assert sorted(os.path.basename(p) for p in created) == sorted(ref.DIRS)
    configs = setup_tool.generate_configs(str(ours))
    assert len(configs) == 2
    ref.setup_project_structure(str(theirs))
    ref.generate_configs(str(theirs))
    for name in ("config.yaml", "quick_config.yaml"):
        with open(ours / "configs" / name) as f, open(theirs / "configs" / name) as g:
            assert yaml.safe_load(f) == yaml.safe_load(g), name
    # Existing files are kept.
    assert setup_tool.generate_configs(str(ours)) == []


def test_install_self_test_on_cpu():
    assert setup_tool.run_install_test("cpu")


def test_main_skips_steps_whose_package_is_missing(tmp_path, monkeypatch, capsys):
    real = setup_tool._installed
    monkeypatch.setattr(setup_tool, "_installed",
                        lambda m: m not in ("yaml", "matplotlib") and real(m))
    assert setup_tool.main(["--root", str(tmp_path), "--test",
                            "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "config files: skipped: yaml is not installed" in out
    assert "plot save: skipped: matplotlib is not installed" in out
    assert "setup complete" in out
    assert not (tmp_path / "configs" / "config.yaml").exists()
    monkeypatch.setattr(setup_tool, "_installed",
                        lambda m: m != "scipy" and real(m))
    assert setup_tool.main(["--root", str(tmp_path)]) == 1


def test_self_test_runs_on_the_card_unless_asked(tmp_path, monkeypatch, capsys):
    """Without `--platform cpu` the self-test asks for the card, and fails
    where there is none."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert setup_tool.main(["--root", str(tmp_path), "--test"]) == 1
    assert "[FAIL] device matmul: no CUDA device" in capsys.readouterr().out
