"""mrgan_tpu_torch — the PyTorch / CUDA port of ``mrgan_tpu`` for an NVIDIA H100.

The JAX package ``mrgan_tpu`` stays the reference; every module here keeps
the name of the module it ports, so each counterpart is easy to find, and
the CPU tests hold each port against its JAX original on the same inputs.

The port covers the material-classifier serving slice: impact windowing
and resampling (``ops.resample``, ``data.preprocess``), the log-mel frontend
with its hand-written CUDA kernel (``ops.mel``, ``ops.mel_cuda``,
``csrc/mel_power.cu``), modality assembly and scaling (``ops.features``,
``ops.scaler``), the eval-mode discriminator (``models.nets``), pickled-numpy
checkpoints (``utils.params_io``) and ``serve.MaterialClassifier``; and the
paper's tables: the semi-supervised GAN (``train.gan``, ``train.protocol``),
the MLP and SVM baselines (``train.mlp``, ``train.svm`` with the in-tree SMO
of ``csrc/svm_smo.cpp``), the loader (``data.mreo``) and the table CLIs
(``cli.tables``); the variant zoo (``variants``, ``cli.wgan_grid``, the
biLSTM recurrence kernels of ``csrc/lstm_scan.cu``) with its random forest
(``train.forest``); the autoencoder GAN, the activation maps, the function
API ``train.protocol.mr_gan`` and offline preprocessing
(``data.preprocess.run``, ``cli.preprocess``); the live collection
(``acquisition``, ``cli.collect``); and several ranks under
``torch.distributed`` (``parallel``, ``ops.mel.logmel_sharded``) with
the bf16 weight shadows (``train.optim.mm_shadow``) and profiling
(``utils.profiling``).

Nothing here imports JAX, scikit-learn, JAX's checkpoint library or the
JAX package: the machine with the card has none of them.
"""

__version__ = "0.1.0"

MATERIALS = ("plastic", "glass", "fabric", "metal", "wood", "ceramic")
NUM_CLASSES = len(MATERIALS)

MODALITY_NAMES = (
    "Force",
    "Temperature",
    "Force and Temperature",
    "Contact mic",
    "Temperature and Contact Mic",
    "Force, Temperature, and Contact Mic",
    "Force and Contact Mic",
)
