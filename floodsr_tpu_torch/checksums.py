"""Artifact integrity: SHA-256 digests for cached model weights.

Same contract as the reference's checksum helpers (``floodsr/checksums.py``):
hex digests compare case-insensitively, a mismatch in :func:`assert_sha256`
raises ``ValueError`` with both digests in the message.
"""

from __future__ import annotations

import hashlib
from pathlib import Path


def compute_sha256(file_path: str | Path, chunk_size: int | None = None) -> str:
    """Hex SHA-256 of a file, streamed so multi-GB artifacts stay cheap.

    ``chunk_size`` is accepted for signature compatibility; streaming is
    delegated to :func:`hashlib.file_digest`, which picks its own buffer.
    """
    path = Path(file_path)
    assert path.is_file(), f"cannot hash {path}: not a file (or missing)"
    with path.open("rb") as handle:
        return hashlib.file_digest(handle, "sha256").hexdigest()


def _matches(file_path: str | Path, expected: str) -> tuple[bool, str]:
    assert expected, "an expected digest is required"
    actual = compute_sha256(file_path)
    return actual.casefold() == expected.strip().casefold(), actual


def verify_sha256(file_path: str | Path, expected_sha256: str) -> bool:
    """Whether the file's digest equals ``expected_sha256`` (case-insensitive)."""
    ok, _ = _matches(file_path, expected_sha256)
    return ok


def assert_sha256(file_path: str | Path, expected_sha256: str) -> None:
    """Like :func:`verify_sha256` but raises ``ValueError`` on mismatch."""
    ok, actual = _matches(file_path, expected_sha256)
    if not ok:
        raise ValueError(
            f"sha256 mismatch for {file_path}: wanted {expected_sha256}, computed {actual}"
        )
