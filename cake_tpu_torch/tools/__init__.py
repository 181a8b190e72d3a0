"""Command-line tools of the port (`python -m cake_tpu_torch.tools.<name>`)."""
