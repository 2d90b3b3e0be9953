"""Tiny ``.env`` loader, the port's copy of the JAX package's
``utils/env.py`` (the counterpart of python-dotenv's ``load_dotenv()``):
KEY=VALUE lines, ``#`` comments, an optional ``export`` prefix, and the
existing environment wins (dotenv's default override=False).
``cli.router`` calls it first.
"""

from __future__ import annotations

import os
from pathlib import Path


def load_env_file(path: str = ".env") -> dict:
    """Load KEY=VALUE pairs into os.environ (existing keys win). Returns
    the parsed mapping; missing file -> empty dict, like load_dotenv.

    A relative ``path`` not found in the CWD is searched for UPWARD through
    parent directories (dotenv's find_dotenv behavior) — so running a CLI
    from a project subdirectory still picks up the project's ``.env``.
    """
    p = Path(path)
    if not p.is_absolute() and not p.exists():
        for parent in Path.cwd().resolve().parents:
            candidate = parent / path
            if candidate.exists():
                p = candidate
                break
    if not p.exists():
        return {}
    parsed = {}
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        if line.startswith("export "):
            line = line[len("export ") :]
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip()
        if value and value[0] in "'\"":  # quoted: keep everything inside
            value = value.strip(value[0])
        else:  # unquoted: dotenv strips trailing inline comments
            value = value.split(" #", 1)[0].split("\t#", 1)[0].strip()
        # ${DOTENV_DIR} expands to the directory holding this .env file, so
        # a committed .env can point at repo-relative paths without baking
        # in one machine's checkout path
        value = value.replace("${DOTENV_DIR}", str(p.parent.resolve()))
        parsed[key] = value
        os.environ.setdefault(key, value)
    return parsed
