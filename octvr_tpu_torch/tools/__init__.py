"""Command-line instruments of the port (``python -m octvr_tpu_torch.tools.<name>``)."""
