"""Utilities of the port (:mod:`.synth`: synthetic corpora, numpy only)."""
