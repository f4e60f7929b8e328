// K4 (fused_potential_kernel.cuh) and the functor check's evaluation
// (density_eval.cuh) for one shape (shape.cuh), with the C entry points of
// fused_potential.cu: built at first use into its own library by
// ops/kernels/_build.py::shape_libraries, one nvcc process beside K3's
// (fused_warmup_shape.cu).  An entry point called with another family, D or
// width returns cudaErrorInvalidValue.
#include <cuda_runtime.h>

#include "c_api.cuh"
#include "fused_potential_kernel.cuh"
#include "shape.cuh"

extern "C" int binf_fused_potential_hmc(int family, int D, int G,
                                        const binf::DensityOperands* ops,
                                        const binf::RunArgs* args, void* stream, int* grid) {
  return (int)binf::with_shape<binf::ShapeDensity, binf::kShapeG>(
      family, D, G, *ops, [&](auto dens, auto lanes) {
        return binf::launch<decltype(dens), decltype(lanes)::value>(dens, *args,
                                                                    (cudaStream_t)stream, grid);
      });
}

extern "C" int binf_fused_potential_occupancy(int family, int D, int G,
                                              const binf::DensityOperands* ops, int dense,
                                              int* out) {
  out[0] = out[1] = 0;
  return (int)binf::with_shape<binf::ShapeDensity, binf::kShapeG>(
      family, D, G, *ops, [&](auto dens, auto lanes) {
        return binf::occupancy<decltype(dens), decltype(lanes)::value>(dens, dense, out);
      });
}

extern "C" int binf_density_eval(int family, int D, int G, const binf::DensityOperands* ops,
                                 const float* q, int n, float* U, float* g, void* stream,
                                 int* grid) {
  return (int)binf::with_shape<binf::ShapeDensity, binf::kShapeG>(
      family, D, G, *ops, [&](auto dens, auto lanes) {
        return binf::density_eval<decltype(dens), decltype(lanes)::value>(
            dens, q, n, U, g, (cudaStream_t)stream, grid);
      });
}
