"""The SWC detection-module suite (one module per file, as in the
reference's ``mythril/analysis/module/modules/`` ⚠unv)."""

from . import (  # noqa: F401
    arbitrary_jump,
    arbitrary_storage,
    delegatecall,
    deprecated_ops,
    ether_thief,
    exceptions,
    external_calls,
    integer,
    multiple_sends,
    predictable_vars,
    requirements_violation,
    state_change_external,
    suicide,
    transaction_order,
    tx_origin,
    unchecked_retval,
    user_assertions,
)

__all__ = [
    "arbitrary_jump", "arbitrary_storage", "delegatecall", "deprecated_ops",
    "ether_thief", "exceptions", "external_calls", "integer",
    "multiple_sends", "predictable_vars", "requirements_violation",
    "state_change_external", "suicide", "transaction_order", "tx_origin",
    "unchecked_retval", "user_assertions",
]
