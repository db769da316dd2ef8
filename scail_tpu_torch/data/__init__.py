"""data (scail_tpu_torch)."""
