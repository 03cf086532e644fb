"""JSON / JSONL and TSV reading and writing and stable object hashing (port
of :mod:`kirag_tpu.utils.io`).

``hash_object`` hashes a canonical JSON serialization with blake2b and writes
it in base 58, so the KiRAG loop's triple ids are the reference's, stable
across processes and Python versions.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Iterable, List, Sequence, Tuple

_B58_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"


def _b58encode(data: bytes) -> str:
    num = int.from_bytes(data, "big")
    out = []
    while num > 0:
        num, rem = divmod(num, 58)
        out.append(_B58_ALPHABET[rem])
    for byte in data:  # leading zero bytes become '1's, as in standard base58
        if byte != 0:
            break
        out.append(_B58_ALPHABET[0])
    return "".join(reversed(out))


def _canonicalize(obj: Any) -> Any:
    """A JSON-serializable canonical form of ``obj``."""
    if isinstance(obj, dict):
        return {str(k): _canonicalize(v) for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))}
    if isinstance(obj, (list, tuple)):
        return [_canonicalize(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "tolist"):  # numpy arrays / scalars, tensors
        return _canonicalize(obj.tolist())
    return repr(obj)


def hash_object(obj: Any) -> str:
    """Stable base58 blake2b hash of a (JSON-like) Python object."""
    payload = json.dumps(_canonicalize(obj), sort_keys=True, ensure_ascii=False).encode("utf-8")
    return _b58encode(hashlib.blake2b(payload).digest())


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


def load_tsv(path: str) -> List[Tuple[str, ...]]:
    """Every line of a TSV file as a tuple of its tab-separated fields (the
    newline dropped, no header skipped)."""
    with open(path, encoding="utf-8") as fin:
        return [tuple(line.rstrip("\n").split("\t")) for line in fin]


def save_tsv(data: Iterable[Sequence[Any]], path: str) -> str:
    """Write each item as a tab-separated line, floats as ``%.6f``."""
    with open(path, "w", encoding="utf-8") as fout:
        for item in data:
            fout.write("\t".join(f"{x:.6f}" if isinstance(x, float) else str(x)
                                  for x in item) + "\n")
    return path
