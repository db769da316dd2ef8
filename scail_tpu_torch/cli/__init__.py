"""cli (scail_tpu_torch)."""
