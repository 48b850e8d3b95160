"""One job a call through ``TohrService.handle_tohr``, in the process.

A front (``traffic/<mix>.json`` ``front``) gives ``body(jobs)``, the
machine-interface payload of one call from the jobs' own bodies, and
``handler(service)``, which sends a payload and returns one result a job.
"""

from __future__ import annotations


def body(jobs: list[dict]) -> dict:
    (job,) = jobs
    return job


def handler(service):
    return lambda payload: [service.handle_tohr(payload)]
