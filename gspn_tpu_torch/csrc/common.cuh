// Helpers shared by the point-op kernels.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace gspn {

constexpr unsigned kFullMask = 0xffffffffu;

// dx*dx + dy*dy + dz*dz with round-to-nearest intrinsics in exactly the
// order of the JAX package (gspn_tpu/ops/common.py pairwise_sqdist,
// fps.py:118, interpolate.py:62): ((dx*dx + dy*dy) + dz*dz). The intrinsics
// are never contracted into FMAs, so the result is bitwise equal to the
// plain PyTorch version whatever the -fmad setting.
__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

}  // namespace gspn
