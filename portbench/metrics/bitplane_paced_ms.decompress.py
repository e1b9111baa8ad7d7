"""Device idle ms a call between two operations launched inside one
``mgard.bitplane`` span of the decompress: the device waiting on the
codec's host."""

from portbench import spans


def read(t):
    return spans.paced_ms(t, "decompress", "mgard.bitplane")
