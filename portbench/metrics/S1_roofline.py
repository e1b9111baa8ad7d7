"""S1 (mass_solve, all its kernels): the bytes of every solve of a compress
at the peak bandwidth over their traced time."""


def read(t):
    return t.roofline_pct("compress", "S1")
