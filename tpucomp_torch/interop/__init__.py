"""CPU interop oracles (:mod:`.cpu`: liblz4 through ctypes)."""
