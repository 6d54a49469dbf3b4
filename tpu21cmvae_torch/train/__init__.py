from tpu21cmvae_torch.train.adam import AdamState, adam_init, adam_update  # noqa: F401
from tpu21cmvae_torch.train.callbacks import EarlyStopping, ReduceLROnPlateau  # noqa: F401
from tpu21cmvae_torch.train.loop import History, fit  # noqa: F401
