"""Command-line entry points of the port (``python -m pacingpseudo_torch.cli.<name>``)."""
