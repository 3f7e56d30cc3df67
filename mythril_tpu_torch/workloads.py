"""The ERC-20 transfer workload: the concrete interpreter's benchmark
fixture, the port's copy of the JAX package's ``workloads.py``.

P lanes each run ``transfer(0x1000 + lane, 0)`` on the hand-assembled
token contract (:func:`mythril_tpu_torch.disassembler.asm.erc20_like`,
the stand-in for a solc-compiled OpenZeppelin ERC-20) from one caller.
"""

from __future__ import annotations

import numpy as np

from .config import LimitsConfig
from .core import Corpus, make_env, make_frontier
from .disassembler import ContractImage
from .disassembler.asm import abi_call, erc20_like

TRANSFER_SELECTOR = 0xA9059CBB
TRANSFER_CALLDATA_LEN = 68  # 4-byte selector + two 32-byte args
BENCH_CALLER = 0xDEADBEEF


def erc20_transfer_workload(P: int, limits: LimitsConfig, device="cpu"):
    """(code, frontier, env, corpus): P lanes each running transfer(to, 0)."""
    code = erc20_like()
    img = ContractImage.from_bytecode(code, limits.max_code)
    corpus = Corpus.from_images([img], device)
    cd = np.zeros((P, limits.calldata_bytes), dtype=np.uint8)
    for i in range(P):
        blob = abi_call(TRANSFER_SELECTOR, 0x1000 + i, 0)
        cd[i, : len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    f = make_frontier(
        P, limits, calldata=cd,
        calldata_len=np.full(P, TRANSFER_CALLDATA_LEN, dtype=np.int32),
        caller=BENCH_CALLER, device=device,
    )
    env = make_env(P, device=device)
    return code, f, env, corpus
