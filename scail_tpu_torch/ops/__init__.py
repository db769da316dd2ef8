"""ops (scail_tpu_torch)."""
