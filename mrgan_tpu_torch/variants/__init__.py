"""The reference's variants (others/): the WGAN-LP-CT / GAN trainers of
wganlpctsemi.py (``wgan``) and its residual, biLSTM, SVM and random-forest
baselines (``baselines``); the autoencoder-pretrained GAN of
mr_gan_autoencoder.py (``autoencoder``) and the activation maps of
mr_nn_activation_map.py (``activation_maps``)."""
