"""Host-to-device copy ms per field in the decompress (the tables again)."""


def read(t):
    return t.copy_ms("decompress", "HtoD")
