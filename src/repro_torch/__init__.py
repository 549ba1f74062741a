"""``repro_torch`` — the graph-accelerator memory-access simulator in
PyTorch, with its hot kernels written by hand in CUDA for Hopper.

A port of the JAX package ``repro`` (which stays the reference): the same
modules under the same names, the same results bit for bit.  Entry
point: :func:`repro_torch.sim.simulate`.  It runs on the card unless the
caller passes ``device="cpu"``.
"""
