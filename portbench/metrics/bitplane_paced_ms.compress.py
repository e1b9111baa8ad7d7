"""Device idle ms a call between two operations launched inside one
``mgard.bitplane`` span of the compress: the device waiting on the
codec's host (its launches, and its waits for the device)."""

from portbench import spans


def read(t):
    return spans.paced_ms(t, "compress", "mgard.bitplane")
