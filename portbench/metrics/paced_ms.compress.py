"""Device idle ms a call in the gaps whose middle lies inside the port's
span ``mgard.encode``: the device waiting on the host's enqueue."""

from portbench import spans


def read(t):
    return spans.paced_ms(t, "compress", "mgard.encode")
