// The AR(1) trajectory posterior (example/statespace.py) in (dynamics,
// log precision) space, as a device functor the whole-run kernels are
// templated over.  With q = (phi_raw, drift, x0, t), phi = tanh(phi_raw),
// lambda = e^t and the trajectory x_0 = x0, x_{s+1} = phi x_s + drift:
//
//     U(q) = lambda/2 sum_s (x_s - y_s)^2 - (T/2 + a) t + b lambda
//            + sum_k (q_k - m_k)^2 / (2 v_k) + C
//
// (a Gaussian error model by precision, a Gamma(a, b) prior on lambda
// under the log transform, whose Jacobian adds t, and N(m, v) on the three
// dynamics; C gathers the constants, so that U is minus the transformed
// posterior's log density).  The gradient of the data term is sum_s r_s
// dx_s/dtheta, and the three tangents dx_s/dphi, dx_s/ddrift, dx_s/dx0 are
// carried forward through the recurrence beside x_s:
//
//     dx_{s+1}/dphi = x_s + phi dx_s/dphi,  dx_{s+1}/ddrift = 1 + phi dx_s/ddrift,
//     dx_{s+1}/dx0 = phi dx_s/dx0
//
// so one pass over the T steps gives U and grad U with nothing stored per
// step (the adjoint pass backwards would need the whole trajectory in
// every thread); dphi/dphi_raw = 1 - phi^2.  The plain PyTorch version is
// AR1Density.potential_and_grad in binf_tpu_torch/ops/kernels/densities.py,
// and the cards check both against torch.func of the posterior.
//
// One evaluation is ~16 T + 30 float operations, one tanhf and one expf;
// y and the operands live in shared memory.  The recurrence is affine, so
// a lane group splits it into segments (lanes.cuh): a segment of L steps
// maps a state as x -> phi^L x + drift S_L with S_L = sum_{j<L} phi^j,
// and the tangents by the same map's derivatives.
#pragma once

namespace binf {

struct AR1Density {
  static constexpr int D = 4;

  const float* y;     // (T,) observations, device memory
  const float* ipv;   // (3,) 1 / prior variance of the dynamics
  const float* pm;    // (3,) prior mean of the dynamics
  const float* scal;  // (3,): T/2 + a, b, C
  int n;              // T

  __host__ __device__ int shared_floats() const { return n + 9; }

  __device__ void stage(float* smem) {
    float* sy = smem;
    float* s = smem + n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) sy[i] = y[i];
    for (int i = threadIdx.x; i < 3; i += blockDim.x) {
      s[i] = ipv[i];
      s[3 + i] = pm[i];
      s[6 + i] = scal[i];
    }
    y = sy;
    ipv = s;
    pm = s + 3;
    scal = s + 6;
  }

  // The recurrence's state at a step: x_s and its three tangents
  // dx_s / d(phi, drift, x0), and the four sums the gradient needs.
  struct State {
    float x, t_phi, t_drift, t_x0;
  };
  struct Sums {
    float sumsq, a_phi, a_drift, a_x0;
  };

  // Steps [s0, s1) from state v, adding each residual's terms to m.
  __device__ __forceinline__ void run(float phi, float drift, State v, int s0, int s1,
                                      Sums& m) const {
    for (int s = s0; s < s1; ++s) {
      const float r = v.x - y[s];
      m.sumsq = fmaf(r, r, m.sumsq);
      m.a_phi = fmaf(r, v.t_phi, m.a_phi);
      m.a_drift = fmaf(r, v.t_drift, m.a_drift);
      m.a_x0 = fmaf(r, v.t_x0, m.a_x0);
      v.t_phi = fmaf(phi, v.t_phi, v.x);
      v.t_drift = fmaf(phi, v.t_drift, 1.0f);
      v.t_x0 = phi * v.t_x0;
      v.x = fmaf(phi, v.x, drift);
    }
  }

  // After the sums: grad U into g, and U
  __device__ __forceinline__ float close(const float (&q)[D], float phi, const Sums& m,
                                         float (&g)[D]) const {
    const float t = q[3];
    const float lam = expf(t);
    float prior = 0.0f, qc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      qc[k] = q[k] - pm[k];
      prior = fmaf(qc[k] * qc[k], ipv[k], prior);
    }
    g[0] = fmaf(lam * m.a_phi, 1.0f - phi * phi, qc[0] * ipv[0]);
    g[1] = fmaf(lam, m.a_drift, qc[1] * ipv[1]);
    g[2] = fmaf(lam, m.a_x0, qc[2] * ipv[2]);
    g[3] = 0.5f * lam * m.sumsq - scal[0] + scal[1] * lam;
    return 0.5f * lam * m.sumsq - scal[0] * t + scal[1] * lam + 0.5f * prior + scal[2];
  }
};

}  // namespace binf
