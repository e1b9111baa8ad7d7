"""Share of the traced compress range in which neither a kernel nor a copy
ran on the device."""


def read(t):
    return t.idle_pct("compress")
