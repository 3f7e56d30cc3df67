"""mythril_tpu_torch — the symbolic-execution security analyzer for EVM
bytecode on PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The same frontier-first design as the JAX package ``mythril_tpu`` beside
it (a struct-of-arrays frontier of (contract, path) lanes, an SSA tape of
symbolic expressions, the SWC detection suite over batched states),
written in PyTorch. Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
