"""K5 (gpk_detail): its bytes at the peak bandwidth over its traced time,
in the compress."""


def read(t):
    return t.roofline_pct("compress", "K5")
