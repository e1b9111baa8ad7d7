"""Kernel ms per field of S1 (mass_solve) in the decompress."""


def read(t):
    return t.layer_ms("decompress", ("s1",))
