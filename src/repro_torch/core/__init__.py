"""DRAM model, traces, the fused serve and the accelerator trace models."""
