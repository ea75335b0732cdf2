// f32 K2's tf32x3 row pass on clusters of 1 block (phi_pool_bwd_rows.cuh).

#include "phi_pool_bwd_rows.cuh"

template <>
cudaError_t pcc::launch_tf32x3_rows<1>(const Tf32RowsArgs& a, int max_clusters, int* n_clusters,
                                      cudaStream_t stream) {
  return rows_launch<1>(a, max_clusters, n_clusters, stream);
}
