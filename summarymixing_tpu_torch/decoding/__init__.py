"""Decoding of the port."""
