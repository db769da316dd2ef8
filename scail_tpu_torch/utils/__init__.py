"""utils (scail_tpu_torch)."""
