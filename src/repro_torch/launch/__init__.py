"""Serving launcher (``python -m repro_torch.launch.serve``)."""
