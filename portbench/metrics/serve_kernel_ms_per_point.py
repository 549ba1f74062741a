"""Device milliseconds of the fused serve's two kernels
(``serve_prepass_kernel``, ``serve_records_kernel``) in the traced window,
over the grid points it completed."""

SERVE_KERNELS = ("serve_prepass_kernel", "serve_records_kernel")


def serve_us(device):
    return sum(b - a for name, a, b in device
               if any(k in name for k in SERVE_KERNELS))


def read(r):
    device = r.get("device")
    if not device or not r.get("points"):
        return None
    us = serve_us(device)
    return us / 1e3 / r["points"] if us > 0 else None
