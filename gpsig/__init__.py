"""gpsig — signature-kernel Gaussian processes in JAX, run on NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
``maudl3116/GPSig`` (signature covariances for GPs on sequential data,
sparse variational inference with inducing tensors/sequences, natural
gradients, the SigGPDE untruncated PDE kernel, VOSF orthogonal features,
and a new full-Bayes NUTS path), designed for device meshes. See SURVEY.md
for the reference analysis and README.md for the component map.
"""

from gpsig.kernels.signature import (  # noqa: F401
    SignatureCosine,
    SignatureKernel,
    SignatureLinear,
    SignaturePoly,
    SignatureRBF,
)
from gpsig.kernels.pde import UntruncatedSignatureKernel  # noqa: F401
from gpsig.kernels.low_rank import (  # noqa: F401
    LowRankSignatureKernel,
    LowRankSignatureRBF,
)
from gpsig.kernels.vosf import (  # noqa: F401
    ExplicitSignatureKernel,
    OrthogonalSignatureFeatures,
)
from gpsig.inducing import (  # noqa: F401
    InducingSequences,
    InducingTensors,
    make_inducing_sequences_from_data,
    make_inducing_tensors_from_data,
)
from gpsig.models.gpr import GPR  # noqa: F401
from gpsig.models.svgp import SVGP  # noqa: F401
from gpsig import likelihoods  # noqa: F401

__version__ = "0.1.0"
