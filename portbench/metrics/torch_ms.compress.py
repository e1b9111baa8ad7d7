"""Kernel ms per field of plain PyTorch stages: every kernel that is
neither the port's nor a library's."""


def read(t):
    return t.layer_ms("compress", ("torch",))
