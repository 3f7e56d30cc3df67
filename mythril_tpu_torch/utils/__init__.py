"""Host utilities (durable writes, the local signature database)."""
