"""Kernel ms per field of S1 (mass_solve) in the compress."""


def read(t):
    return t.layer_ms("compress", ("s1",))
