"""Runnable experiments of the port (``python -m
routeformer_torch.experiments.<name>``)."""
