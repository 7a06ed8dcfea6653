"""The variant zoo of others/wganlpctsemi.py: the WGAN-LP-CT / GAN trainers
(``wgan``) and the residual, biLSTM, SVM and random-forest baselines
(``baselines``)."""
