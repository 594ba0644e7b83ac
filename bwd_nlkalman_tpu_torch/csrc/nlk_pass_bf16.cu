// K1's instances over bfloat16 DCT bands (the bf16 window path); the
// kernels, their design and the C entries are in nlk_pass.cuh and
// nlk_pass.cu. A file of its own so that its nvcc runs beside the float32
// one.
#include "nlk_pass.cuh"

namespace bnlk_nlk {

template int launch_dct<__nv_bfloat16>(const float*, const uint8_t*, const float*,
                                       __nv_bfloat16*, uint8_t*, int, int, int, int,
                                       cudaStream_t);
template int launch_sites<__nv_bfloat16>(const SiteArgs<__nv_bfloat16>&, int, int,
                                         cudaStream_t);
template int launch_aggregate<__nv_bfloat16>(const AggArgs<__nv_bfloat16>&, int,
                                             cudaStream_t);

}  // namespace bnlk_nlk
