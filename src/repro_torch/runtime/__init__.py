"""Failure handling of the port (own copy of ``repro.runtime.fault``):
step recovery, and the parameter server's retry and shard-death drills."""
