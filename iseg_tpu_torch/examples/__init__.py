"""Runnable examples of the port (``python -m iseg_tpu_torch.examples.<name>``)."""
