"""Probes and measurement tools of the port; each runs as a module
(``python -m ptrt_tpu_torch.tools.<name>``)."""
