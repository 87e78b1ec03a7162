"""Command-line entry points of the port: ``python -m cvsd_tpu_torch.cli`` lists them."""
