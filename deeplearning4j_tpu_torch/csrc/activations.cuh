// The elementwise activations of the GEMM kernels' epilogues
// (matmul_bias_act.cu, matmul_bias_act_int8.cu), applied to the f32 value.

#pragma once

#include <cuda_runtime.h>

namespace dl4j {

__device__ __forceinline__ float softplus_f(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
}

// The ids are the port's ACTIVATION_IDS table (kernels/impls.py); a test holds
// the two tables equal. Every formula is the one conf/activations.py applies.
__device__ __forceinline__ float apply_act(int act, float z) {
  switch (act) {
    case 0:  // identity
      return z;
    case 1:  // sigmoid
      return 1.f / (1.f + expf(-z));
    case 2:  // tanh
      return tanhf(z);
    case 3:  // relu
      return fmaxf(z, 0.f);
    case 4:  // relu6
      return fminf(fmaxf(z, 0.f), 6.f);
    case 5:  // leakyrelu
      return z >= 0.f ? z : 0.01f * z;
    case 6:  // elu
      return z > 0.f ? z : expm1f(z);
    case 7:  // selu
      return 1.0507009873554805f * (z > 0.f ? z : 1.6732632423543772f * expm1f(z));
    case 8: {  // gelu (tanh approximation)
      const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
      return 0.5f * z * (1.f + tanhf(u));
    }
    case 9:  // softplus
      return softplus_f(z);
    case 10:  // softsign
      return z / (1.f + fabsf(z));
    case 11:  // swish
      return z / (1.f + expf(-z));
    case 12:  // mish
      return z * tanhf(softplus_f(z));
    case 13:  // hardsigmoid
      return fminf(fmaxf(0.2f * z + 0.5f, 0.f), 1.f);
    case 14:  // hardtanh
      return fminf(fmaxf(z, -1.f), 1.f);
    case 15:  // cube
      return z * z * z;
    case 16: {  // rationaltanh
      const float y = 2.f * z / 3.f;
      const float a = fabsf(y);
      const float s = (y > 0.f) ? 1.f : ((y < 0.f) ? -1.f : 0.f);
      return 1.7159f * s * (1.f - 1.f / (1.f + a + y * y + 1.41645f * (y * y * y * y)));
    }
    case 17:  // rectifiedtanh
      return fmaxf(tanhf(z), 0.f);
    case 18:  // thresholdedrelu
      return z > 1.f ? z : 0.f;
    default:
      return z;
  }
}
constexpr int kNumActs = 19;

}  // namespace dl4j
