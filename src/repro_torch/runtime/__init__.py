"""Failure handling of the port's training loop (own copy of
``repro.runtime.fault``'s single-process part)."""
