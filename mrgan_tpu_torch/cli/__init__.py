"""Command-line entry points of the port: ``python -m
mrgan_tpu_torch.cli.tables`` (the ``mr-gan-torch`` script), the Table-1 GAN
sweep of mr_gan.py."""
