"""Command-line entry points (``python -m ...cli.simulate``)."""
