"""The refusal of what this package's engine does not run.

Every cut (other strategies, fork blocks, the berlin gas schedule,
checkpoints, the instruction profiler, dynamic loading, corpus/serve
modes, plugin discovery) is refused with this error before any device
work.
"""

from __future__ import annotations


class UnsupportedConfiguration(ValueError):
    """The request needs a part of the analyzer this package lacks."""
