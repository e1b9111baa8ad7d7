"""Kernel ms per field of the decompose: the port's transform kernels (K1,
K5; K7, K8, K13 where they run) and the cuBLAS GEMMs of the correction."""


def read(t):
    return t.layer_ms("compress", ("transform", "cublas"))
