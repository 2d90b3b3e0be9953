"""A model configuration as the yardstick reads it: the whole object of
``configs/<name>.json``, independent of the program's own config class.
Its ``family`` key names the file that reads its sizes
(``families/<family>.py``)."""

from __future__ import annotations

import json
from pathlib import Path

# the keys of a configuration file that are not sizes of the model
META_KEYS = ("name", "source", "derived_from", "reduced", "assumed",
             "assumed_why", "family")
# the family of a configuration file without a ``family`` key
DEFAULT_FAMILY = "progen"


def load_config(path: Path) -> dict:
    """The configuration file's whole object."""
    return json.loads(Path(path).read_text())


def family_name(raw: dict) -> str:
    return raw.get("family", DEFAULT_FAMILY)


def program_dict(raw: dict) -> dict:
    """The sizes to hand the program's config class: the file without
    its descriptive keys."""
    return {k: v for k, v in raw.items() if k not in META_KEYS}
