"""Generate the CLI reference of the PyTorch/CUDA port from live ``--help`` output.

The port's twin of ``docs/scripts/build_cli_reference.py``: the same commands,
rendered from ``floodsr_tpu_torch.cli``'s argparse tree (prog
``floodsr-torch``), so the page can never drift from the parser.

Usage: ``python docs/scripts/build_cli_reference_torch.py > docs/cli_reference_torch.md``
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from floodsr_tpu_torch.cli import _parse_arguments  # noqa: E402

COMMANDS = [
    [],
    ["models"],
    ["models", "list"],
    ["models", "fetch"],
    ["tohr"],
    ["serve"],
    ["doctor"],
    ["cache"],
    ["cache", "info"],
    ["cache", "purge"],
]


def _help_for(tokens: list[str]) -> str:
    buffer = io.StringIO()
    # argparse wraps to the terminal's width: pin it, so the page is the same
    # from a terminal, a pipe or a test
    with mock.patch.dict(os.environ, {"COLUMNS": "80"}), contextlib.redirect_stdout(buffer):
        try:
            _parse_arguments([*tokens, "--help"])
        except SystemExit:
            pass
    return buffer.getvalue()


def render() -> str:
    """The whole page, as ``main`` prints it."""
    parts = [
        "# floodsr-torch CLI reference\n",
        "_Generated from live `--help` output by docs/scripts/build_cli_reference_torch.py._\n",
        "The command line of the PyTorch/CUDA port (`python -m floodsr_tpu_torch.cli`,\n"
        "or `floodsr-torch` once installed). It runs on the GPU unless `--device cpu`\n"
        "is given.\n",
    ]
    for tokens in COMMANDS:
        title = " ".join(["floodsr-torch", *tokens])
        parts += [f"## `{title}`\n", "```text", _help_for(tokens).rstrip(), "```\n"]
    return "\n".join(parts)


def main() -> int:
    print(render())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
