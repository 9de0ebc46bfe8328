"""Helpers of the port outside the codec: image file IO, the stream debug
views, timing, and the frames its smoke run and probes decode."""
