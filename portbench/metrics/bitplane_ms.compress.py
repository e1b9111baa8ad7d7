"""Device ms a call of the kernels and copies launched inside the port's
span ``mgard.bitplane`` (every codec of ``ops/bitplane.py``: the
segmented K2-K4, the chunked, the per-group and the wide ``encode64``)
in the compress."""

from portbench import spans


def read(t):
    return spans.launched_ms(t, "compress", "mgard.bitplane")
