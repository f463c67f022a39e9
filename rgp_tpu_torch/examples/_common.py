"""Shared argument handling of the example scripts."""

from __future__ import annotations

import argparse
import json


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the ``--device`` and ``--seed`` every script
    takes."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def emit(record: dict) -> dict:
    """Print ``record`` as one JSON line and return it."""
    print(json.dumps(record))
    return record
