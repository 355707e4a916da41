"""Serving pieces of the port: the speculative-decoding math (``spec``)."""
