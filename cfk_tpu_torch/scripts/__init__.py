"""Scripts of the port, each the counterpart of one under the repo's
``scripts/`` and run as ``python -m cfk_tpu_torch.scripts.<name>``."""
