"""4-byte selector -> function signature database.

Reference: ``mythril/support/signatures.py`` (⚠unv) — sqlite cache +
remote 4byte.directory lookups. Three tiers here: a built-in table of
common signatures (selectors computed with the in-repo keccak, which
doubles as a self-check), an optional user JSON file, and an optional
REMOTE 4byte.directory-shaped endpoint (``MYTHRIL_4BYTE_URL`` or the
``remote_url`` parameter) queried on local miss and memoized into the
local table. The public 4byte.directory is unreachable in this
zero-egress image, so the remote tier is loopback-tested the same way
the RPC client is (tests/test_signatures_remote.py). ``Issue.function``
is labeled through this (VERDICT r2: "Signature DB absent").
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Union

from ..ops.keccak import keccak256_host

_COMMON_SIGNATURES = [
    "transfer(address,uint256)",
    "transferFrom(address,address,uint256)",
    "approve(address,uint256)",
    "balanceOf(address)",
    "allowance(address,address)",
    "totalSupply()",
    "name()",
    "symbol()",
    "decimals()",
    "owner()",
    "transferOwnership(address)",
    "renounceOwnership()",
    "mint(address,uint256)",
    "burn(uint256)",
    "burnFrom(address,uint256)",
    "deposit()",
    "withdraw(uint256)",
    "withdraw()",
    "pause()",
    "unpause()",
    "kill()",
    "destroy()",
    "setOwner(address)",
    "initialize()",
    "fallback()",
    "safeTransferFrom(address,address,uint256)",
    "ownerOf(uint256)",
    "tokenURI(uint256)",
    "getApproved(uint256)",
    "setApprovalForAll(address,bool)",
    "isApprovedForAll(address,address)",
    "permit(address,address,uint256,uint256,uint8,bytes32,bytes32)",
    "swapExactTokensForTokens(uint256,uint256,address[],address,uint256)",
    "flashLoan(address,address,uint256,bytes)",
]


def selector_of(signature: str) -> str:
    """4-byte selector hex (no 0x) of a canonical signature string."""
    return keccak256_host(signature.encode())[:4].hex()


class SignatureDB:
    """selector (8 hex chars) -> list of signature strings."""

    def __init__(self, path: Optional[str] = None,
                 remote_url: Optional[str] = None,
                 remote_timeout: float = 3.0):
        self._by_sel: Dict[str, List[str]] = {}
        for sig in _COMMON_SIGNATURES:
            self.add(sig)
        self.path = path
        if path and os.path.exists(path):
            with open(path) as fh:
                for sel, sigs in json.load(fh).items():
                    self._by_sel.setdefault(sel.lower().removeprefix("0x"),
                                            []).extend(sigs)
        # remote 4byte.directory tier (reference: signature lookups hit
        # https://www.4byte.directory/api/v1/signatures/?hex_signature=…
        # ⚠unv); opt-in via arg or env, misses memoized as misses for
        # the process so an offline endpoint costs one timeout per
        # selector, not one per issue
        self.remote_url = remote_url or os.environ.get("MYTHRIL_4BYTE_URL")
        self.remote_timeout = remote_timeout
        self._remote_miss: set = set()

    def add(self, signature: str) -> str:
        sel = selector_of(signature)
        bucket = self._by_sel.setdefault(sel, [])
        if signature not in bucket:
            bucket.append(signature)
        return sel

    def lookup(self, selector: Union[str, bytes, int]) -> List[str]:
        if isinstance(selector, bytes):
            sel = selector[:4].hex()
        elif isinstance(selector, int):
            sel = f"{selector & 0xFFFFFFFF:08x}"
        else:
            sel = selector.lower().removeprefix("0x")[:8]
        hit = self._by_sel.get(sel)
        if hit:
            return list(hit)
        if self.remote_url and sel not in self._remote_miss:
            for sig in self._lookup_remote(sel):
                self.add(sig)
            if sel not in self._by_sel:
                self._remote_miss.add(sel)
        return list(self._by_sel.get(sel, []))

    def _lookup_remote(self, sel: str) -> List[str]:
        """Query a 4byte.directory-shaped endpoint:
        ``GET {url}?hex_signature=0x{sel}`` returning
        ``{"results": [{"text_signature": "..."}]}``. Any failure is a
        silent miss — labeling must never break an analysis."""
        import urllib.parse
        import urllib.request

        try:
            q = urllib.parse.urlencode({"hex_signature": "0x" + sel})
            join = "&" if "?" in self.remote_url else "?"
            with urllib.request.urlopen(
                    f"{self.remote_url}{join}{q}",
                    timeout=self.remote_timeout) as resp:
                doc = json.load(resp)
            return [r["text_signature"] for r in doc.get("results", [])
                    if isinstance(r.get("text_signature"), str)]
        except Exception:  # noqa: BLE001 — offline/any failure = miss
            return []

    def save(self, path: Optional[str] = None) -> None:
        if not (path or self.path):
            raise ValueError("SignatureDB.save: no path configured")
        with open(path or self.path, "w") as fh:
            json.dump(self._by_sel, fh, indent=1, sort_keys=True)
