"""Device ms a call of the operations launched inside the port's span
``mgard.recompose`` (``transform.recompose_to_level``)."""

from portbench import spans


def read(t):
    return spans.launched_ms(t, "decompress", "mgard.recompose")
