"""The emulator families — direct, autoencoder, VAE and the deep
ensemble — their checkpoint format and the Keras h5 import."""

from tpu21cmvae_torch.models.direct import DirectEmulator  # noqa: F401
from tpu21cmvae_torch.models.autoencoder import AutoEncoder, AutoEncoderEmulator  # noqa: F401
from tpu21cmvae_torch.models.vae import VAE, VAEEmulator  # noqa: F401
from tpu21cmvae_torch.models.io_keras import load_keras_mlp, save_keras_mlp  # noqa: F401
from tpu21cmvae_torch.models.checkpoint import (  # noqa: F401
    load_checkpoint,
    read_checkpoint_meta,
    save_checkpoint,
)
from tpu21cmvae_torch.models.ensemble import DeepEnsemble  # noqa: F401


def load_model(path: str, data=None, *, device):
    """Restore any saved emulator on ``device`` by the ``kind`` in its
    checkpoint header (DirectEmulator, AutoEncoderEmulator, VAEEmulator);
    a directory of ``member_*.npz`` checkpoints (what
    :meth:`DeepEnsemble.save` writes) loads as a :class:`DeepEnsemble`.
    Reads the files of either package."""
    import os

    if os.path.isdir(path):
        return DeepEnsemble.load(path, data, device=device)
    kind = read_checkpoint_meta(path).get("kind", "DirectEmulator")
    cls = {
        "DirectEmulator": DirectEmulator,
        "AutoEncoderEmulator": AutoEncoderEmulator,
        "VAEEmulator": VAEEmulator,
    }[kind]
    return cls.from_checkpoint(path, data, device=device)
