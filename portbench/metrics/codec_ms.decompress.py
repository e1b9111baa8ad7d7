"""Kernel ms per field of the bitplane decode: K4 (K11, K15 where they
run)."""


def read(t):
    return t.layer_ms("decompress", ("codec",))
