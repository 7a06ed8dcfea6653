"""Command-line entry points of the port: ``python -m
mrgan_tpu_torch.cli.tables [gan|nn|svm]`` (the ``mr-gan-torch``,
``mr-nn-torch`` and ``mr-svm-torch`` scripts), the table sweeps of
mr_gan.py, mr_nn.py and mr_svm.py; and ``python -m
mrgan_tpu_torch.cli.wgan_grid`` (``mr-wgan-grid-torch``), the variant zoo's
grid search of wganlpctsemi.py."""
