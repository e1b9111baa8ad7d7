"""Device ms a call of the operations launched inside the port's span
``mgard.dequantize``: the flat route's split of the integer stream and
its dequantization before the recomposition."""

from portbench import spans


def read(t):
    return spans.launched_ms(t, "decompress", "mgard.dequantize")
