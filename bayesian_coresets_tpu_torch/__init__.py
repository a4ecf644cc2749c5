"""bayesian_coresets_tpu_torch — the PyTorch/CUDA port of bayesian_coresets_tpu.

A second package beside the JAX one, grown slice by slice and held against
it by tests on identical inputs.  The slices so far are the flagship path
in both its stages, and the variational coreset constructions:

- the Hilbert coreset on logistic regression: data, a Laplace fit, the
  black-box projection, and a sparse-NNLS solver (``ops/snnls.py``): GIGA,
  Frank-Wolfe and orthogonal matching pursuit, whose per-iteration select
  is a hand-written CUDA kernel on CUDA tensors (``ops/giga_select.py``,
  ``csrc/giga_select.cu``), and importance and uniform sampling;
- weighted NUTS on the coreset (``mcmc/``): Laplace preconditioning, chains
  batched on one device, per-chain or pooled adaptation, diagnostics;
- SparseVI and BatchPSVI (``coresets/sparsevi.py``, ``coresets/bpsvi.py``)
  with projected Adam (``ops/opt.py``), the conjugate Gaussian model and
  its exact tangent family, the uniform-sampling baseline, and the active
  set re-solve of ``HilbertCoreset.optimize()`` (``ops/nnls.py``, and the
  exact host solver in ``native/``);
- the Poisson and linear-regression models (``models/poisson.py``,
  ``models/linreg.py``) and the linear-regression exact tangent family;
- the streamed int8-resident construction on one device
  (``HilbertCoreset(stream_chunk_size=...)``, ``parallel/streamed.py``,
  ``ops.snnls.make_consts_quantized``), for datasets whose f32 projection
  does not fit on the card, and the span recorder and phase timers
  (``utils/profiling.py``).

``ops/packed_select.py`` (``csrc/packed_select.cu``) carries the JAX
package's packed-int4 select probe.  The experiment drivers
(``experiments/``, with seeded generators from ``utils/prng.py``) are not
imported here, as in the JAX package.  The entry points run on the CUDA card:
data given as numpy arrays or lists goes to :func:`default_device`, the
card unless ``set_default_device("cpu")`` was called (where there is no
card and the CPU was not chosen, they raise); a tensor stays on the device
it was given on.

It imports torch and never JAX or the JAX package.
"""

from . import coresets, mcmc, models, ops, parallel, utils
from . import utils as util           # reference spelling: bc.util.set_verbosity
from .ops import snnls                # reference pattern: bc.snnls.GIGA
from .coresets import (
    BatchPSVICoreset,
    BlackBoxProjector,
    Coreset,
    FamilyProjector,
    HilbertCoreset,
    Projector,
    SparseVICoreset,
    TangentFamily,
    UniformSamplingCoreset,
    center_glls,
    gaussian_tangent_family,
    identity_tangent_family,
    linreg_tangent_family,
    project,
)
from .utils import default_device, set_default_device, set_tolerance, set_verbosity

__version__ = "0.1.0"

__all__ = [
    "coresets",
    "mcmc",
    "models",
    "ops",
    "parallel",
    "utils",
    "util",
    "snnls",
    "Coreset",
    "HilbertCoreset",
    "SparseVICoreset",
    "BatchPSVICoreset",
    "UniformSamplingCoreset",
    "Projector",
    "FamilyProjector",
    "BlackBoxProjector",
    "TangentFamily",
    "center_glls",
    "project",
    "gaussian_tangent_family",
    "identity_tangent_family",
    "linreg_tangent_family",
    "set_tolerance",
    "set_verbosity",
    "default_device",
    "set_default_device",
]
