"""Kernels launched per field decompressed, counted in the trace."""


def read(t):
    return t.launches("decompress")
