"""Launches of the program's hand-written kernels in the window
(``repro_torch.kernels.launch_counts()``, read before and after it), over
the grid points the window completed."""


def read(r):
    if not r.get("points") or r.get("launches") is None:
        return None
    return sum(r["launches"].values()) / r["points"]
