// K3 (fused_warmup_kernel.cuh) for one shape (shape.cuh), with the C entry
// points of fused_warmup.cu: built at first use into its own library by
// ops/kernels/_build.py::shape_libraries, one nvcc process beside K4's
// (fused_potential_shape.cu).  An entry point called with another family, D
// or width returns cudaErrorInvalidValue.
#include <cuda_runtime.h>

#include "c_api.cuh"
#include "fused_warmup_kernel.cuh"
#include "shape.cuh"

extern "C" int binf_fused_warmup(int family, int D, int G, const binf::DensityOperands* ops,
                                 const binf::WarmupArgs* args, void* stream, int* grid) {
  return (int)binf::with_shape<binf::ShapeDensity, binf::kShapeG>(
      family, D, G, *ops, [&](auto dens, auto lanes) {
        return binf::launch<decltype(dens), decltype(lanes)::value>(dens, *args,
                                                                    (cudaStream_t)stream, grid);
      });
}

extern "C" int binf_fused_warmup_max_ctas(int family, int D, int G,
                                          const binf::DensityOperands* ops, int* out) {
  out[0] = out[1] = out[2] = 0;
  return (int)binf::with_shape<binf::ShapeDensity, binf::kShapeG>(
      family, D, G, *ops, [&](auto dens, auto lanes) {
        return binf::max_ctas<decltype(dens), decltype(lanes)::value>(dens, out);
      });
}
