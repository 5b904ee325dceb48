"""SC_RB (scalable spectral clustering with Random Binning features) in
PyTorch, with hand-written CUDA kernels for the card.

Public API (the names of ``repro.core``, as far as they are ported):
  - ``SCRBModel``                                    fit / transform /
    predict / save / load
  - ``SCRBConfig`` / ``sc_rb`` / ``spectral_embed``  Alg. 2, one-shot
  - ``RBMap`` / ``FEATURE_MAPS``                     stage-1 map (rb only)
  - ``make_rb_params`` / ``rb_transform``            Alg. 1
  - ``build_normalized_adjacency``                   Eq. 5/6
  - ``top_k_eigenpairs`` / ``lobpcg``                the eigensolver
  - ``kmeans`` / ``row_normalize``                   final stage
  - ``metrics``                                      Table 2 metrics
"""
from repro_torch.core.rb import (  # noqa: F401
    RBParams, make_rb_params, rb_transform, suggest_d_g, suggest_sigma,
)
from repro_torch.core.graph import (  # noqa: F401
    NormalizedAdjacency, build_normalized_adjacency, degrees_from_counts,
    rb_degrees_and_counts,
)
from repro_torch.core.eigensolver import (  # noqa: F401
    EigResult, lobpcg, top_k_eigenpairs,
)
from repro_torch.core.kmeans import (  # noqa: F401
    KMeansResult, kmeans, row_normalize,
)
from repro_torch.core.executor import (  # noqa: F401
    ExecutionPlan, FitResult, execute, plan_from_config,
)
from repro_torch.core.options import (  # noqa: F401
    CompressiveOptions, PartitionOptions, SolverOptions,
)
from repro_torch.core.featuremap import FEATURE_MAPS, RBMap  # noqa: F401
from repro_torch.core.rowmatrix import DeviceRows, FittedFeatures  # noqa: F401
from repro_torch.core.model import SCRBModel  # noqa: F401
from repro_torch.core.pipeline import (  # noqa: F401
    SCRBConfig, SCRBResult, SpectralEmbedding, sc_rb, spectral_embed,
)
from repro_torch.core import metrics  # noqa: F401
