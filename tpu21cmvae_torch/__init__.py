"""tpu21cmvae_torch — the PyTorch/CUDA port of ``tpu21cmvae``.

The same emulator, likelihoods and samplers, on tensors on a device the
caller names, with the JAX package's TPU kernels rewritten as CUDA
kernels for Hopper (``ops/kernels/``). Module paths and names follow the
JAX package, so each counterpart sits at the same path. The port imports
neither ``jax`` nor ``tpu21cmvae``; importing it does no I/O and builds
no kernel.
"""

__version__ = "0.1.0"

from tpu21cmvae_torch.calibration import (  # noqa: F401
    BatchGOFResult,
    GOFResult,
    SBCResult,
    goodness_of_fit,
    goodness_of_fit_batch,
    sbc,
)
from tpu21cmvae_torch.data.synthetic import synthetic_dataset, synthetic_params  # noqa: F401
from tpu21cmvae_torch.deploy import (  # noqa: F401
    ExportedFn,
    export_loglik,
    export_predict,
    export_valgrad,
    load_artifact,
    save_artifact,
    save_loglik_artifact,
    save_predict_artifact,
    save_valgrad_artifact,
)
from tpu21cmvae_torch.flows import (  # noqa: F401
    FlowEvidenceResult,
    FlowResult,
    evidence_with_flow,
    evidence_with_flow_batch,
    fit_flow,
    fit_flow_batch,
    flow_evidence,
    flow_evidence_batch,
)
from tpu21cmvae_torch.foregrounds import (  # noqa: F401
    MarginalizedNoise,
    foreground_basis,
    linlog_basis,
    marginalize_foreground,
    polynomial_basis,
    powerlaw_basis,
)
from tpu21cmvae_torch.models import load_model  # noqa: F401
from tpu21cmvae_torch.models.autoencoder import AutoEncoder, AutoEncoderEmulator  # noqa: F401
from tpu21cmvae_torch.models.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from tpu21cmvae_torch.models.direct import DirectEmulator  # noqa: F401
from tpu21cmvae_torch.models.ensemble import DeepEnsemble  # noqa: F401
from tpu21cmvae_torch.models.vae import VAE, VAEEmulator  # noqa: F401
from tpu21cmvae_torch.nested import NestedResult, nested_sampling, nested_sampling_batch  # noqa: F401
from tpu21cmvae_torch.noisescale import ScaleMarginalNoise, marginalize_noise_scale  # noqa: F401
from tpu21cmvae_torch.ops.loglik import make_loglik, make_loglik_and_grad  # noqa: F401
from tpu21cmvae_torch.ops.transforms import (  # noqa: F401
    Normalizer,
    par_transform,
    preproc,
    unpreproc,
)
from tpu21cmvae_torch.priors import GaussianBoxPrior  # noqa: F401
from tpu21cmvae_torch.sampling._common import make_emcee_log_prob  # noqa: F401
from tpu21cmvae_torch.sampling.driver import run_batched_chain, sample_to_ess  # noqa: F401
from tpu21cmvae_torch.sampling.evidence import (  # noqa: F401
    EvidenceComparison,
    EvidenceResult,
    LaplaceResult,
    compare_evidence,
    laplace_evidence,
    laplace_evidence_multi,
    log_evidence,
)
from tpu21cmvae_torch.sampling.fit import (  # noqa: F401
    FitResult,
    ProfileResult,
    fit_map,
    profile_likelihood,
)
from tpu21cmvae_torch.sampling.gradient import (  # noqa: F401
    ChEESSampleResult,
    NUTSSampleResult,
    sample_chees,
    sample_hmc,
    sample_nuts,
)
from tpu21cmvae_torch.sampling.mh import sample_ensemble, sample_mh  # noqa: F401
from tpu21cmvae_torch.sampling.predictive import PredictiveBand, posterior_predictive  # noqa: F401
from tpu21cmvae_torch.sampling.pt import sample_pt  # noqa: F401
from tpu21cmvae_torch.sampling.results import (  # noqa: F401
    BatchSampleResult,
    PTSampleResult,
    SampleResult,
)
from tpu21cmvae_torch.sampling.reweight import WeightedPosterior, reweight  # noqa: F401
from tpu21cmvae_torch.sampling.smc import SMCResult, sample_smc  # noqa: F401
from tpu21cmvae_torch.utils.config import (  # noqa: F401
    AE_EMULATOR_TRAIN_DEFAULT,
    AE_EMULATOR_TRAIN_STRONG,
    AE_TRAIN_DEFAULT,
    AE_TRAIN_STRONG,
    DIRECT_TRAIN_DEFAULT,
    DIRECT_TRAIN_STRONG,
    AutoEncoderConfig,
    DirectEmulatorConfig,
    MLPConfig,
    TrainConfig,
    VAEConfig,
)
from tpu21cmvae_torch.utils.frequency import (  # noqa: F401
    NU_0,
    default_frequencies,
    default_redshifts,
    freq2redshift,
    redshift2freq,
)
from tpu21cmvae_torch.utils.metrics import band_mask, error  # noqa: F401
from tpu21cmvae_torch.vi import ADVIResult, fit_advi, fit_advi_batch  # noqa: F401

PAR_LABELS = ["fstar", "Vc", "fx", "tau", "alpha", "nu_min", "Rmfp"]
"""Names of the 7 astrophysical parameters, in input-column order
(reference ``emulator.py:293-301``)."""
