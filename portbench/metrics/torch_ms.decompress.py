"""Kernel ms per field of plain PyTorch stages in the decompress."""


def read(t):
    return t.layer_ms("decompress", ("torch",))
