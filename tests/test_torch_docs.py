"""The port's CLI reference page: ``docs/cli_reference_torch.md`` is what
``docs/scripts/build_cli_reference_torch.py`` renders from
``floodsr_tpu_torch.cli``, over the JAX script's commands."""

import importlib.util
import re
from pathlib import Path

import pytest

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
PAGE = ROOT / "docs" / "cli_reference_torch.md"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", ROOT / "docs" / "scripts" / f"{name}.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


page_script = _load("build_cli_reference_torch")


def _section(page: str, title: str) -> str:
    match = re.search(rf"^## `{re.escape(title)}`\n(.*?)(?=^## |\Z)", page, re.S | re.M)
    assert match, f"no section {title!r}"
    return match.group(1)


def test_page_is_what_the_script_renders():
    assert PAGE.read_text(encoding="utf-8").strip() == page_script.render().strip(), (
        "docs/cli_reference_torch.md is stale; regenerate with "
        "`python docs/scripts/build_cli_reference_torch.py > docs/cli_reference_torch.md`"
    )


def test_script_covers_the_jax_scripts_commands():
    assert page_script.COMMANDS == _load("build_cli_reference").COMMANDS
    titles = re.findall(r"^## `(.*)`$", PAGE.read_text(encoding="utf-8"), re.M)
    assert titles == [" ".join(["floodsr-torch", *tokens]) for tokens in page_script.COMMANDS]


@pytest.mark.parametrize("command", ["tohr", "serve"])
def test_section_lists_device_mesh_and_scene_mode(command):
    section = _section(PAGE.read_text(encoding="utf-8"), f"floodsr-torch {command}")
    assert section.startswith("\n```text\nusage: floodsr-torch " + command)
    for flag in ("--device {cuda,cpu}", "--mesh SPEC", "--scene-mode {replicated,banded}"):
        assert flag in section, flag
