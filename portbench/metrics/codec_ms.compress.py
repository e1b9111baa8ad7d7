"""Kernel ms per field of the bitplane encode: K2 and K3 (K12, K14, K16
where they run)."""


def read(t):
    return t.layer_ms("compress", ("codec",))
