// dfruntime — native host runtime for deepfusion_tpu.
//
// Equivalent of the reference's C++ runtime layer: aligned buffers
// (util/memory.cc:21-40), weight pre-packing (the OIhw4i16o4i transform
// consumed by src/jit_conv_kernel.cc:512-564 — here the int8 product
// layout (kh*kw*icp, ocp)), the u8->s8 shift + correction transform
// feeding the int8 products, and the balance211/nd_iterator work
// partitioners (util/deepfusion_utils.h:190-255) used for host-side batch
// sharding and the staging pipeline.
//
// Exposed as a plain C ABI consumed via ctypes (deepfusion_tpu/native/
// runtime.py); every entry point has a numpy fallback so the Python layer
// works without the shared library.
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- memory

// 4096-byte default alignment, like deepfusion::memory
// (include/deepfusion.h:80).
void* df_aligned_malloc(size_t size, size_t alignment) {
  void* p = nullptr;
  if (alignment < sizeof(void*)) alignment = sizeof(void*);
  if (posix_memalign(&p, alignment, size) != 0) return nullptr;
  return p;
}

void df_aligned_free(void* p) { free(p); }

// ---------------------------------------------------------------- packing

// OIHW int8 -> (kw*kh*icp, ocp) int8, rows ordered (kw, kh, ic), channels
// zero-padded. Matches deepfusion_tpu.ops.layout.pack_conv_weights (the kw
// tap is outermost so the kernel's per-tap weight sub-matrix is one
// contiguous block of kh*icp rows).
void df_pack_conv_weights(const int8_t* wei, int64_t oc, int64_t ic,
                          int64_t kh, int64_t kw, int64_t icp, int64_t ocp,
                          int8_t* out) {
  memset(out, 0, (size_t)(kh * kw * icp * ocp));
  for (int64_t o = 0; o < oc; ++o) {
    const int8_t* w_o = wei + o * ic * kh * kw;
    for (int64_t i = 0; i < ic; ++i) {
      const int8_t* w_oi = w_o + i * kh * kw;
      for (int64_t r = 0; r < kh; ++r) {
        for (int64_t s = 0; s < kw; ++s) {
          // row = ((s*kh + r)*icp + i), col = o
          out[((s * kh + r) * icp + i) * ocp + o] = w_oi[r * kw + s];
        }
      }
    }
  }
}

// (oc1, ic, 1, 1) int8 -> (icp, ocp) int8. Matches layout.pack_1x1_weights.
void df_pack_1x1_weights(const int8_t* wei, int64_t oc1, int64_t ic,
                         int64_t icp, int64_t ocp, int8_t* out) {
  memset(out, 0, (size_t)(icp * ocp));
  for (int64_t o = 0; o < oc1; ++o)
    for (int64_t i = 0; i < ic; ++i) out[i * ocp + o] = wei[o * ic + i];
}

// 128 * column-sum of a packed (rows, cols) int8 matrix -> int32[cols].
// The exact u8->s8 shift correction (ops/layout.py docstring).
void df_u8_shift_correction(const int8_t* packed, int64_t rows, int64_t cols,
                            int32_t* out) {
  for (int64_t c = 0; c < cols; ++c) out[c] = 0;
  for (int64_t r = 0; r < rows; ++r) {
    const int8_t* row = packed + r * cols;
    for (int64_t c = 0; c < cols; ++c) out[c] += row[c];
  }
  for (int64_t c = 0; c < cols; ++c) out[c] *= 128;
}

// u8 NHWC activation -> spatially padded, channel-padded, shifted s8.
// in: (n, ih, iw, ic) u8; out: (n, ih+2ph, owp, icp) s8 pre-filled by this
// routine with -128 (the shifted zero-pad value). owp is the caller-chosen
// padded width (>= iw + 2*pw; the Pallas kernel wants a multiple of 8).
void df_prep_src(const uint8_t* in, int64_t n, int64_t ih, int64_t iw,
                 int64_t ic, int64_t ph, int64_t pw, int64_t owp,
                 int64_t icp, int8_t* out) {
  const int64_t ohp = ih + 2 * ph;
  memset(out, 0x80, (size_t)(n * ohp * owp * icp));  // 0x80 == -128
  for (int64_t b = 0; b < n; ++b) {
    for (int64_t r = 0; r < ih; ++r) {
      const uint8_t* src_row = in + ((b * ih + r) * iw) * ic;
      int8_t* dst_row = out + ((b * ohp + (r + ph)) * owp + pw) * icp;
      for (int64_t c = 0; c < iw; ++c) {
        const uint8_t* s = src_row + c * ic;
        int8_t* d = dst_row + c * icp;
        for (int64_t k = 0; k < ic; ++k)
          d[k] = (int8_t)((int32_t)s[k] - 128);
        // channel pad slots stay -128 (weights there are zero)
      }
    }
  }
}

// u8 NHWC -> the PACKED-DOMAIN image: (n, (h+2*halo)*iwp, cp) centered s8
// with every non-image slot -128 (ops/packed.py pack_image — the
// model-boundary pack of the layout-persistent chain).
void df_pack_image(const uint8_t* in, int64_t n, int64_t h, int64_t w,
                   int64_t c, int64_t cp, int64_t halo, int64_t col_off,
                   int64_t iwp, int8_t* out) {
  const int64_t rows = h + 2 * halo;
  memset(out, 0x80, (size_t)(n * rows * iwp * cp));   // 0x80 == -128
  for (int64_t b = 0; b < n; ++b) {
    for (int64_t r = 0; r < h; ++r) {
      const uint8_t* src_row = in + ((b * h + r) * w) * c;
      int8_t* dst_row =
          out + ((b * rows + (r + halo)) * iwp + col_off) * cp;
      for (int64_t x = 0; x < w; ++x) {
        const uint8_t* sp = src_row + x * c;
        int8_t* dp = dst_row + x * cp;
        for (int64_t k = 0; k < c; ++k)
          dp[k] = (int8_t)((int32_t)sp[k] - 128);
      }
    }
  }
}

// Space-to-depth regroup of a (conv-padded) u8 image:
// (n, ih2*sh, iw2*sw, ic) -> (n, ih2, iw2, sh*sw*ic) with channel group
// g = (row%sh)*sw + (col%sw) (ops/layout.py _s2d_regroup — the strided
// conv's model-boundary prep).
void df_s2d_regroup(const uint8_t* in, int64_t n, int64_t ih2, int64_t iw2,
                    int64_t sh, int64_t sw, int64_t ic, uint8_t* out) {
  const int64_t ih = ih2 * sh, iw = iw2 * sw, c2 = sh * sw * ic;
  for (int64_t b = 0; b < n; ++b) {
    for (int64_t r = 0; r < ih; ++r) {
      const int64_t r2 = r / sh, a = r % sh;
      const uint8_t* src_row = in + ((b * ih + r) * iw) * ic;
      for (int64_t x2 = 0; x2 < iw2; ++x2) {
        uint8_t* dst =
            out + ((b * ih2 + r2) * iw2 + x2) * c2 + a * sw * ic;
        // sw consecutive source columns land in sw*ic consecutive lanes
        memcpy(dst, src_row + (x2 * sw) * ic, (size_t)(sw * ic));
      }
    }
  }
}

// ---------------------------------------------------------------- sched

// Near-equal contiguous work split (util/deepfusion_utils.h:190-208).
void df_balance211(int64_t amount, int64_t team, int64_t member,
                   int64_t* start, int64_t* end) {
  if (team <= 1 || amount <= 1) {
    *start = (member == 0) ? 0 : amount;
    *end = amount;
    return;
  }
  const int64_t base = amount / team, extra = amount % team;
  if (member < extra) {
    *start = member * (base + 1);
    *end = *start + base + 1;
  } else {
    *start = extra * (base + 1) + (member - extra) * base;
    *end = *start + base;
  }
}

// Flat index -> multi-dim coords (util/deepfusion_utils.h:210-230).
void df_nd_iterator_init(int64_t start, const int64_t* dims, int64_t ndims,
                         int64_t* coords) {
  for (int64_t i = ndims - 1; i >= 0; --i) {
    coords[i] = start % dims[i];
    start /= dims[i];
  }
}

// Advance coords; returns 0 on wrap (util/deepfusion_utils.h:232-244).
int df_nd_iterator_step(int64_t* coords, const int64_t* dims, int64_t ndims) {
  for (int64_t i = ndims - 1; i >= 0; --i) {
    if (++coords[i] < dims[i]) return 1;
    coords[i] = 0;
  }
  return 0;
}

int df_runtime_version() { return 2; }

}  // extern "C"
