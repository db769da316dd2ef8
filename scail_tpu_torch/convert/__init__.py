"""convert (scail_tpu_torch)."""
