"""K6 (gpk_prolong_add): its bytes at the peak bandwidth over its traced
time, in the decompress."""


def read(t):
    return t.roofline_pct("decompress", "K6")
