"""Runnable examples of the port (``python -m rtvqa_tpu_torch.examples.<name>``)."""
