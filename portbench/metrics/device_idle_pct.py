"""Share of the traced window in which no operation ran on the device
(the union of kernels, copies and sets in the profile), in %."""

from portbench.devicetrace import busy_us


def read(r):
    device, span = r.get("device"), r.get("traced_window_us")
    if not device or not span or span[1] <= span[0]:
        return None
    return 100.0 * (1.0 - busy_us(device) / (span[1] - span[0]))
