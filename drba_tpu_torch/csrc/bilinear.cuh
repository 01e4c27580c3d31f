// F.interpolate's align_corners=False bilinear (upsample_bilinear2d) for the
// kernels that resize as they write: block_input.cu (an IFBlock's input) and
// block_output.cu (its output).
#pragma once

namespace drba {

// upsample_bilinear2d's source index and weights along one axis: output
// index o of an axis resized from `in` samples with scale = in / out in
// f32; source index max(scale * (o + 0.5) - 0.5, 0), the lower tap its
// truncation, the upper one clamped to the edge
__device__ __forceinline__ void axis(float scale, int o, int in, int& i0, int& i1, float& l0,
                                     float& l1) {
  const float r = fmaxf(scale * (static_cast<float>(o) + 0.5f) - 0.5f, 0.f);
  i0 = static_cast<int>(r);
  i1 = i0 + (i0 < in - 1 ? 1 : 0);
  l1 = r - static_cast<float>(i0);
  l0 = 1.f - l1;
}

// upsample_bilinear2d's sum of the taps (row y0: v00, v01; row y1: v10,
// v11) in f32, in its order; an even integer factor gives the mean of the
// 2x2 taps exactly
__device__ __forceinline__ float bilerp(float ly0, float ly1, float lx0, float lx1, float v00,
                                        float v01, float v10, float v11) {
  return ly0 * (lx0 * v00 + lx1 * v01) + ly1 * (lx0 * v10 + lx1 * v11);
}

}  // namespace drba
