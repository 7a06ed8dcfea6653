"""Command-line entry points of the port: ``python -m
mrgan_tpu_torch.cli.tables [gan|nn|svm]`` (the ``mr-gan-torch``,
``mr-nn-torch`` and ``mr-svm-torch`` scripts), the table sweeps of
mr_gan.py, mr_nn.py and mr_svm.py; and ``python -m
mrgan_tpu_torch.cli.wgan_grid`` (``mr-wgan-grid-torch``), the variant zoo's
grid search of wganlpctsemi.py; ``cli.autoencoder``
(``mr-gan-autoencoder-torch``, mr_gan_autoencoder.py), ``cli.activation_map``
(``mr-activation-map-torch``, mr_nn_activation_map.py) and
``cli.preprocess`` (``mr-process-data-torch``, processdata.py)."""
