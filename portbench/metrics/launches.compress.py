"""Kernels launched per field compressed, counted in the trace (the port's,
cuBLAS's and PyTorch's)."""


def read(t):
    return t.launches("compress")
