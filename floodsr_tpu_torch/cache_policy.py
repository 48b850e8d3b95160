"""Cache lifecycle management: ``floodsr cache info|purge``.

Implements the cache-policy surface the reference only specifies as future
work (reference: ``docs/dev/adr/0012-cache-policy-and-lifecycle.md:7-37``):
namespace accounting under the user cache dir, age-based purge with a TTL
default of 30 days, and a full purge.
"""

from __future__ import annotations

import logging
import shutil
import time
from pathlib import Path

from floodsr_tpu_torch.cache_paths import get_cache_dir

DEFAULT_TTL_DAYS = 30.0
log = logging.getLogger(__name__)


def cache_info(cache_dir: str | Path | None = None) -> dict[str, object]:
    """Summarize cache contents: per-namespace file counts, bytes, and ages."""
    root = get_cache_dir(cache_dir)
    namespaces: dict[str, dict[str, float | int]] = {}
    total_bytes = 0
    now = time.time()
    for entry in sorted(root.iterdir()) if root.exists() else []:
        if not entry.is_dir():
            continue
        files = [p for p in entry.rglob("*") if p.is_file()]
        size = sum(p.stat().st_size for p in files)
        newest = max((p.stat().st_mtime for p in files), default=now)
        namespaces[entry.name] = {
            "files": len(files),
            "bytes": size,
            "age_days": round((now - newest) / 86400.0, 3),
        }
        total_bytes += size
    return {"cache_dir": str(root), "total_bytes": total_bytes, "namespaces": namespaces}


def cache_purge(
    cache_dir: str | Path | None = None,
    *,
    older_than_days: float | None = None,
    namespace: str | None = None,
) -> dict[str, object]:
    """Remove cached artifacts; returns what was deleted.

    With ``older_than_days`` only namespaces whose newest file exceeds the age
    are removed; otherwise everything (optionally limited to ``namespace``).
    """
    root = get_cache_dir(cache_dir)
    removed: list[str] = []
    freed = 0
    now = time.time()
    for entry in sorted(root.iterdir()) if root.exists() else []:
        if not entry.is_dir():
            continue
        if namespace is not None and entry.name != namespace:
            continue
        files = [p for p in entry.rglob("*") if p.is_file()]
        newest = max((p.stat().st_mtime for p in files), default=0.0)
        if older_than_days is not None and (now - newest) < older_than_days * 86400.0:
            continue
        freed += sum(p.stat().st_size for p in files)
        shutil.rmtree(entry)
        removed.append(entry.name)
        log.info(f"purged cache namespace '{entry.name}'")
    return {"cache_dir": str(root), "removed": removed, "freed_bytes": freed}
