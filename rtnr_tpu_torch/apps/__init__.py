"""Command-line entry points of the port (``python -m rtnr_tpu_torch.apps.<name>``)."""
