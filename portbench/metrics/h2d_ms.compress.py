"""Host-to-device copy ms per field in the compress; the fields are on the
card, so these are tables."""


def read(t):
    return t.copy_ms("compress", "HtoD")
