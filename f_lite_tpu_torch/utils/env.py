"""Minimal .env loader (counterpart of `f_lite_tpu/utils/env.py`'s
`load_dotenv`): the trainer reads credentials such as S3KEY / S3SECRET from
a `.env` file beside the run.

The subset read: KEY=VALUE lines, an optional `export ` prefix, #-comments,
optional single or double quotes; the existing environment wins.
"""

from __future__ import annotations

import os
from pathlib import Path


def load_dotenv(path: str | Path = ".env") -> dict[str, str]:
    """Load KEY=VALUE pairs from `path` into os.environ (no overwrite).

    Returns the parsed mapping (empty if the file doesn't exist).
    """
    path = Path(path)
    if not path.is_file():
        return {}
    parsed: dict[str, str] = {}
    for raw in path.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key = key.strip()
        if key.startswith("export "):
            key = key[len("export "):].strip()
        value = value.strip()
        if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
            value = value[1:-1]
        parsed[key] = value
        os.environ.setdefault(key, value)
    return parsed
