"""Device ms a call of the kernels and copies launched inside the port's
span ``mgard.correction`` (``transform._correction``) in the compress."""

from portbench import spans


def read(t):
    return spans.launched_ms(t, "compress", "mgard.correction")
