"""The fused serve's share of its roofline: the least time the window's
serve calls need to move their bytes at the card's peak bandwidth
(``portbench/roofline.py``, from the shapes of each call), over the
device time of the serve's kernels in the traced window, in %."""

from portbench import roofline
from portbench.metrics.serve_kernel_ms_per_point import serve_us


def read(r):
    device, calls = r.get("device"), r.get("serve_calls")
    if not device or not calls:
        return None
    us = serve_us(device)
    bw = roofline.peak(r.get("kind", ""), "hbm_bytes_per_s")
    if us <= 0 or bw is None:
        return None
    nbytes = sum(roofline.serve_bytes(**c) for c in calls)
    return 100.0 * (nbytes / bw) / (us / 1e6)
