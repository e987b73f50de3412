"""Large-graph sparse backend: padded-CSR containers, bit-packed
patterns, edge-parallel SpMV and masked SpGEMM kernels."""

from .container import CsrMatrix, CscMatrix, csr_from_coo
from .bitpack import pack_pattern, popcount, words_for
from .spmv import csr_mxv, csr_vxm, segment_reduce
from .spgemm import (edge_intersection_counts, masked_spgemm_counts,
                     tricount_sparse, ktruss_sparse)
from .bsr import (tile_pattern, tile_pattern_from_coo, tile_matrix,
                  bsr_masked_mm, masked_mxm,
                  tricount_bsr, TilePattern)
from .ewise import (csr_ewise_add, csr_ewise_mult, csr_apply,
                    csr_select, csr_reduce_rows, csr_reduce_scalar)
from .algorithms import bfs_csr, pagerank_csr
from .esc import csr_spgemm
from .window import (build_window_plan, window_masked_mm,
                     window_masked_count_sum,
                     window_count_sum_triton)
from .tri import (masked_pair_counts, tricount_esc, tricount_auto,
                  tricount_prep_csr, ktruss_esc,
                  allktruss_esc, csr_filter_lanes, csr_tril, csr_triu)
from .mask import csr_accum_mask, csr_clear
from .assign import (csr_subref, csr_extract, csr_assign, csr_subassign,
                     csr_assign_scalar, csr_subassign_scalar)
from .hyper_csc import HyperCscMatrix
from .hyper import (HyperMatrix, hyper_from_coo, hyper_spgemm,
                    hyper_ewise, hyper_mxv, hyper_reduce_scalar,
                    hyper_reduce_vector, hyper_apply, hyper_select,
                    hyper_transpose, hyper_conform, nvec_nonempty,
                    GxB_INDEX_MAX, GxB_HYPER_DEFAULT, GxB_ALWAYS_HYPER,
                    GxB_NEVER_HYPER)
from .hyper_assign import (hyper_subref, hyper_extract, hyper_assign,
                           hyper_subassign, hyper_filter_lanes)
from .vector import SparseVec

__all__ = [
    "CsrMatrix", "CscMatrix", "csr_from_coo", "pack_pattern", "popcount", "words_for",
    "csr_mxv", "csr_vxm", "segment_reduce", "edge_intersection_counts",
    "masked_spgemm_counts", "tricount_sparse", "ktruss_sparse",
    "tile_pattern", "tile_pattern_from_coo", "tile_matrix", "tricount_bsr", "TilePattern",
    "bsr_masked_mm", "masked_mxm", "csr_ewise_add",
    "csr_ewise_mult", "csr_apply", "csr_select", "csr_reduce_rows",
    "csr_reduce_scalar", "bfs_csr", "pagerank_csr",
    "csr_spgemm", "csr_accum_mask", "csr_clear",
    "build_window_plan", "window_masked_mm",
    "window_masked_count_sum", "window_count_sum_triton",
    "masked_pair_counts", "tricount_esc", "tricount_auto",
    "tricount_prep_csr", "ktruss_esc", "allktruss_esc",
    "csr_filter_lanes", "csr_tril", "csr_triu",
    "csr_subref", "csr_extract", "csr_assign", "csr_subassign",
    "csr_assign_scalar", "csr_subassign_scalar",
    "HyperMatrix", "HyperCscMatrix", "hyper_from_coo", "hyper_spgemm",
    "hyper_ewise",
    "hyper_mxv", "hyper_reduce_scalar", "hyper_reduce_vector",
    "hyper_apply", "hyper_select", "hyper_transpose", "hyper_conform",
    "nvec_nonempty", "GxB_INDEX_MAX", "GxB_HYPER_DEFAULT",
    "GxB_ALWAYS_HYPER", "GxB_NEVER_HYPER",
    "hyper_subref", "hyper_extract", "hyper_assign", "hyper_subassign",
    "hyper_filter_lanes", "SparseVec",
]
