"""diffusion (scail_tpu_torch)."""
