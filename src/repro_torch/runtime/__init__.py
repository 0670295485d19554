"""Runtime helpers: the logical-to-physical sharding rules (``sharding``)."""
