"""Helpers of the port outside the codec: the frames its smoke run and
probes decode."""
