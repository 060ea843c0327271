// The pinhole camera's ray direction, derived on the device: shared by the
// camera walks (camera.cu) and the rest-set merge in camera mode (rest.cu),
// so both see the same bits as the materialised pack.
//
// Lane l of a frame block is sample l / (bh*bw) of pixel
// divmod(l % (bh*bw), bw) of the block at block row br, column bc. The
// direction is ((2 (x + ox) / W - 1) aspect scale, (1 - 2 (y + oy) / H)
// scale, 1) in the f32 op order of traverse.py:_camera_dirs (two separate
// multiplies, IEEE division); offs [spp, 2] holds (ox, oy) per sample.
#pragma once

#include "common.cuh"

namespace rt {

__device__ __forceinline__ void camera_dir(const float* __restrict__ offs,
                                           int br, int bc, int lane, int bh,
                                           int bw, float wf, float hf,
                                           float aspect, float scale,
                                           float d[3]) {
  const int p2 = bh * bw;
  const int s = lane / p2;
  const int p = lane % p2;
  const float xi = static_cast<float>(bc * bw + p % bw);
  const float yi = static_cast<float>(br * bh + p / bw);
  const float ox = offs[2 * s];
  const float oy = offs[2 * s + 1];
  d[0] = (2.0f * (xi + ox) / wf - 1.0f) * aspect * scale;
  d[1] = (1.0f - 2.0f * (yi + oy) / hf) * scale;
  d[2] = 1.0f;
}

}  // namespace rt
