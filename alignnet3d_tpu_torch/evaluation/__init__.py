"""Decoding of network outputs into poses."""
