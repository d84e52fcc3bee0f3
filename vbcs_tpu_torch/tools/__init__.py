"""Command-line tools of the port (``python -m vbcs_tpu_torch.tools.<name>``)."""
