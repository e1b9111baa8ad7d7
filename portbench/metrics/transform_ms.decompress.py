"""Kernel ms per field of the recompose: K6 (K9, K10 where they run) and
the cuBLAS GEMMs."""


def read(t):
    return t.layer_ms("decompress", ("transform", "cublas"))
