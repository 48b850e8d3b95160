"""Several jobs a call through ``TohrService.handle_tohr_many``, in the
process: its prefetch decodes the next job's DEM while the current one runs.
See ``tohr.py`` for what a front gives."""

from __future__ import annotations


def body(jobs: list[dict]) -> dict:
    return {"jobs": jobs}


def handler(service):
    return service.handle_tohr_many
