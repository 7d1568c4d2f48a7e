"""Provenance stamping for every JSON artifact the repo writes.

A plain-Python copy of the reference's ``repro/telemetry/provenance.py``.

Before this module every ``results/**/*.json`` blob was schema-less: no way
to tell which commit, config, or artifact-format version produced it. One
shared header fixes that::

    {"schema_version": 1, "git_sha": "10842ad…", "config_digest": "sha256:…",
     "created_unix": 1754680000.0, "writer": "repro_torch.telemetry"}

:func:`provenance` builds the header; :func:`stamp` attaches it to a payload
dict under the ``"provenance"`` key. The ``run_simulated(run_dir=…)``
exporter and the report stamp through here, so every artifact they write is
self-describing.
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import subprocess
import time
from typing import Any

__all__ = ["SCHEMA_VERSION", "provenance", "stamp", "config_digest"]

# Bump when the meaning/layout of emitted artifacts changes incompatibly.
SCHEMA_VERSION = 1


@functools.lru_cache(maxsize=1)
def git_sha() -> str:
    """HEAD commit of the repo this module runs from ('unknown' outside git)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def config_digest(config: Any) -> str:
    """Stable sha256 of any JSON-encodable config (dataclasses via str).

    Key order does not affect the digest; non-JSON leaves fall back to
    ``str``, so arbitrary config objects hash deterministically.
    """
    blob = json.dumps(config, sort_keys=True, default=str,
                      separators=(",", ":"))
    return "sha256:" + hashlib.sha256(blob.encode()).hexdigest()[:16]


def provenance(config: Any = None, **extra: Any) -> dict:
    """The shared artifact header; see module docstring.

    Args:
      config: anything JSON-encodable describing the run configuration —
        digested (not embedded) so artifacts stay small and diffable.
      extra: free-form additional fields (e.g. ``writer='bench_bus'``).
    """
    out = {
        "schema_version": SCHEMA_VERSION,
        "git_sha": git_sha(),
        "created_unix": time.time(),
    }
    if config is not None:
        out["config_digest"] = config_digest(config)
    out.update(extra)
    return out


def stamp(payload: dict, config: Any = None, **extra: Any) -> dict:
    """Attach the provenance header to ``payload`` (in place) and return it.

    Non-dict payloads (bare lists some benches emit) are returned untouched
    — there is nowhere to hang the header without changing their shape.
    """
    if isinstance(payload, dict):
        payload.setdefault("provenance", provenance(config, **extra))
    return payload
