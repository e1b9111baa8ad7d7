"""Device ms a call of the operations launched inside the port's span
``mgard.quantize``: the flat route's scaling, concatenation, rounding
and status guards after the decomposition."""

from portbench import spans


def read(t):
    return spans.launched_ms(t, "compress", "mgard.quantize")
