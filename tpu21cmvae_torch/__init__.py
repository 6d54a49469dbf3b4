"""tpu21cmvae_torch — the PyTorch/CUDA port of ``tpu21cmvae``.

The same emulator, likelihoods and samplers, on tensors on a device the
caller names, with the JAX package's TPU kernels rewritten as CUDA
kernels for Hopper (``ops/kernels/``). Module paths and names follow the
JAX package, so each counterpart sits at the same path. The port imports
neither ``jax`` nor ``tpu21cmvae``; importing it does no I/O and builds
no kernel.
"""

from tpu21cmvae_torch.data.synthetic import synthetic_dataset, synthetic_params  # noqa: F401
from tpu21cmvae_torch.models.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from tpu21cmvae_torch.models.direct import DirectEmulator  # noqa: F401
from tpu21cmvae_torch.ops.loglik import make_loglik, make_loglik_and_grad  # noqa: F401
from tpu21cmvae_torch.ops.transforms import Normalizer  # noqa: F401
from tpu21cmvae_torch.sampling.gradient import sample_hmc  # noqa: F401
from tpu21cmvae_torch.sampling.results import SampleResult  # noqa: F401
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig, MLPConfig  # noqa: F401
