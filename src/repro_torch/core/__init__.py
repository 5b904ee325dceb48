"""SC_RB (scalable spectral clustering with Random Binning features) in
PyTorch, with hand-written CUDA kernels for the card.

Public API (the names of ``repro.core``):
  - ``SCRBModel``                                    fit / transform /
    predict / save / load
  - ``SCRBConfig`` / ``sc_rb`` / ``spectral_embed``  Alg. 2, one-shot
  - ``RBMap`` / ``FEATURE_MAPS`` / ...               stage-1 maps (rb, rff,
    nystrom, lsc) and the dense operands
  - ``METHODS`` / ``BaselineConfig``                 the Table-2 methods
  - ``pairwise_kernel`` / ``rff_transform``          dense kernel blocks
  - ``make_rb_params`` / ``rb_transform``            Alg. 1
  - ``build_normalized_adjacency``                   Eq. 5/6
  - ``top_k_eigenpairs``                             every eigensolver
    (``lobpcg``, ``lobpcg_host_chunked``, ``lanczos``,
    ``subspace_iteration``, randomized and ``auto``)
  - ``compressive``                                  the eigendecomposition-
    free cell (``solver="compressive"``, ``"auto"`` at N ≥ 10⁶)
  - ``ChunkedDense`` / ``ChunkedELL`` / ...          host-chunked storage
  - ``DeviceRows`` / ``HostChunkedRows`` /
    ``MeshRows`` / ``PartitionedRows``               the executor's row
    representations (single, mesh and partitioned placements)
  - ``kmeans`` / ``row_normalize``                   final stage
  - ``metrics``                                      Table 2 metrics
"""
from repro_torch.core.rb import (  # noqa: F401
    RBParams, make_rb_params, rb_transform, suggest_d_g, suggest_sigma,
    laplacian_kernel, gaussian_kernel, expected_nonempty_bins,
)
from repro_torch.core.graph import (  # noqa: F401
    NormalizedAdjacency, build_normalized_adjacency, degrees_from_counts,
    rb_degrees, rb_degrees_and_counts, rb_degrees_exact,
)
from repro_torch.core.streaming import (  # noqa: F401
    ChunkedDense, ChunkedELL, as_row_chunks, build_chunked_adjacency,
    chunked_degrees, chunked_rb_transform, chunked_gram_matvec,
)
from repro_torch.core.eigensolver import (  # noqa: F401
    EigResult, lobpcg, lobpcg_host_chunked, lanczos, subspace_iteration,
    top_k_eigenpairs,
)
from repro_torch.core.kmeans import (  # noqa: F401
    KMeansResult, kmeans, minibatch_kmeans, row_normalize,
    row_normalize_chunks, streaming_kmeans,
)
from repro_torch.core.executor import (  # noqa: F401
    ExecutionPlan, FitResult, execute, plan_from_config,
)
from repro_torch.core.options import (  # noqa: F401
    CompressiveOptions, PartitionOptions, SolverOptions,
)
from repro_torch.core.featuremap import (  # noqa: F401
    FEATURE_MAPS, ChunkedDenseFeatures, LSCMap, NormalizedDenseFeatures,
    NystromMap, RBMap, RFFMap, build_chunked_dense, build_normalized_dense,
    load_fitted, make_feature_map,
)
from repro_torch.core.rff import (  # noqa: F401
    RFFParams, make_rff_params, rff_transform,
)
from repro_torch.core.nystrom import pairwise_kernel  # noqa: F401
from repro_torch.core.rowmatrix import (  # noqa: F401
    DeviceRows, FittedFeatures, HostChunkedRows, MeshRows, PartitionedRows,
)
from repro_torch.core.model import SCRBModel  # noqa: F401
from repro_torch.core.pipeline import (  # noqa: F401
    SCRBConfig, SCRBResult, SpectralEmbedding, sc_rb, spectral_embed,
)
from repro_torch.core.baselines import (  # noqa: F401
    METHOD_FEATURE_MAPS, METHODS, BaselineConfig, BaselineResult,
)
from repro_torch.core import baselines, compressive, metrics  # noqa: F401
