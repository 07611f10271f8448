"""See the rvc_tpu_torch package docstring."""
