"""Device ms a call of the kernels and copies launched inside the port's
span ``mgard.correction`` in the decompress."""

from portbench import spans


def read(t):
    return spans.launched_ms(t, "decompress", "mgard.correction")
