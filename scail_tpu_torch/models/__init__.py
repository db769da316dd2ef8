"""models (scail_tpu_torch)."""
