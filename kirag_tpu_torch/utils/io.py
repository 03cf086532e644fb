"""JSON / JSONL reading and writing (port of ``load_json`` and ``save_json``
from :mod:`kirag_tpu.utils.io`)."""

from __future__ import annotations

import json
from typing import Any


def load_json(path: str, type: str = "json") -> Any:
    if type not in ("json", "jsonl"):
        raise ValueError(f"only json or jsonl format is supported, got {type!r}")
    with open(path, "r", encoding="utf-8") as fin:
        if type == "json":
            return json.loads(fin.read())
        return [json.loads(line) for line in (raw.strip() for raw in fin) if line]


def save_json(data: Any, path: str, type: str = "json", use_indent: bool = False) -> str:
    if type not in ("json", "jsonl"):
        raise ValueError(f"only json or jsonl format is supported, got {type!r}")
    with open(path, "w", encoding="utf-8") as fout:
        if type == "json":
            fout.write(json.dumps(data, indent=4 if use_indent else None))
        else:
            for item in data:
                fout.write(json.dumps(item) + "\n")
    return path
