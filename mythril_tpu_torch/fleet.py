"""Corpus identity.

The part of the JAX package's ``fleet.py`` that the static corpus
campaign uses: :func:`corpus_fingerprint`, stamped into campaign
checkpoints so that a resumed run proves it analyzes the same
contracts. The fleet ledger itself (leased work units across hosts)
comes with the serving and fleet slice.
"""

from __future__ import annotations

import hashlib
from typing import Sequence


def corpus_fingerprint(contracts: Sequence[tuple]) -> str:
    """Stable identity of an ordered ``(name, bytecode)`` corpus slice:
    16 hex chars of sha256 over names + per-contract code digests. Two
    corpora of equal length but different content fingerprint apart (a
    count alone cannot tell "same corpus" from "same size")."""
    h = hashlib.sha256()
    for name, code in contracts:
        h.update(str(name).encode())
        h.update(b"\0")
        h.update(hashlib.sha256(bytes(code)).digest())
    return h.hexdigest()[:16]
