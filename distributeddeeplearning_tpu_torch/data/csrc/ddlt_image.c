/* Native JPEG decode + resample for the TF-free input pipeline.
 *
 * Replaces the PIL hop in data/native_pipeline.py's hot path (JPEG decode
 * is the dominant host cost when feeding a TPU from raw records): libjpeg
 * decompress straight into a scratch buffer, optional central crop, then a
 * separable triangle-filter ("bilinear with antialias") resample matching
 * Pillow's convolution resampling, emitting float32 RGB ready for the
 * mean-subtraction step.
 *
 * Exposed via ctypes (see data/_native_image.py); compiled on demand with
 * `cc -O2 -shared -fPIC ddlt_image.c -ljpeg`.  Returns nonzero on any
 * decode problem (unsupported colorspace, corrupt stream) so the Python
 * caller can fall back to PIL with identical semantics.
 */

#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

typedef struct {
  struct jpeg_error_mgr base;
  jmp_buf jump;
} ddlt_err_mgr;

static void ddlt_error_exit(j_common_ptr cinfo) {
  ddlt_err_mgr *err = (ddlt_err_mgr *)cinfo->err;
  longjmp(err->jump, 1);
}

static void ddlt_emit_message(j_common_ptr cinfo, int msg_level) {
  /* Print nothing, but keep the warning COUNT — the decode path checks
   * num_warnings to reject gray-filled truncated streams (the default
   * handler increments it; a plain no-op would silence that signal). */
  if (msg_level < 0) cinfo->err->num_warnings++;
}

/* Decode a JPEG byte stream to tightly-packed RGB8.  The caller owns *out
 * (free with ddlt_image_free).  Returns 0 on success. */
int ddlt_jpeg_decode(const unsigned char *buf, unsigned long len,
                     unsigned char **out, int *width, int *height) {
  struct jpeg_decompress_struct cinfo;
  ddlt_err_mgr jerr;
  /* volatile: modified between setjmp and longjmp; without it the error
   * path may free a register-restored stale pointer (C11 7.13.2.1 — the
   * libjpeg example.c convention). */
  unsigned char *volatile pixels = NULL;

  cinfo.err = jpeg_std_error(&jerr.base);
  jerr.base.error_exit = ddlt_error_exit;
  jerr.base.emit_message = ddlt_emit_message;
  if (setjmp(jerr.jump)) {
    free(pixels);
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, (unsigned char *)buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  /* RGB output; libjpeg converts YCbCr and grayscale itself.  CMYK/YCCK
   * streams (rare scanned images) are left to the PIL fallback. */
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  int w = (int)cinfo.output_width;
  int h = (int)cinfo.output_height;
  if (w <= 0 || h <= 0 || cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 4;
  }
  size_t stride = (size_t)w * 3;
  pixels = (unsigned char *)malloc(stride * (size_t)h);
  if (!pixels) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 5;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char *row = pixels + stride * cinfo.output_scanline;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  /* emit_message is a no-op, but libjpeg still counts warnings (premature
   * EOF, corrupt scan data).  A "successful" decode that needed warnings
   * is gray-filled garbage — report failure so the PIL path (which raises
   * on truncation) keeps the loud-corruption contract. */
  long warnings = cinfo.err->num_warnings;
  jpeg_destroy_decompress(&cinfo);
  if (warnings > 0) {
    free(pixels);
    return 6;
  }
  *out = pixels;
  *width = w;
  *height = h;
  return 0;
}

void ddlt_image_free(void *p) { free(p); }

/* Pillow-style separable triangle-filter resample (BILINEAR with
 * antialias): filter support scales with the downsampling ratio, so large
 * shrinks average rather than point-sample.  src is RGB8 with given
 * stride; the (cx, cy, cw, ch) window is resampled to (dw, dh) float32
 * RGB in dst (range 0..255). */
int ddlt_resize_bilinear(const unsigned char *src, int sw, int sh,
                         long stride, int cx, int cy, int cw, int ch,
                         float *dst, int dw, int dh) {
  if (cx < 0 || cy < 0 || cw <= 0 || ch <= 0 || cx + cw > sw ||
      cy + ch > sh || dw <= 0 || dh <= 0)
    return 1;

  /* horizontal pass: (ch, cw) -> (ch, dw), float accumulation */
  float *tmp = (float *)malloc(sizeof(float) * (size_t)ch * dw * 3);
  if (!tmp) return 2;

  double xscale = (double)cw / dw;
  double xsupport = xscale > 1.0 ? xscale : 1.0;
  for (int ox = 0; ox < dw; ox++) {
    double center = cx + (ox + 0.5) * xscale;
    int xmin = (int)(center - xsupport + 0.5);
    int xmax = (int)(center + xsupport + 0.5);
    if (xmin < cx) xmin = cx;
    if (xmax > cx + cw) xmax = cx + cw;
    double wsum = 0.0, weights[512];
    int n = xmax - xmin;
    if (n > 512) { /* support bounded by shrink factor ~256x */
      free(tmp);
      return 3;
    }
    for (int i = 0; i < n; i++) {
      double x = (xmin + i + 0.5 - center) / xsupport;
      double tw = x < 0 ? 1.0 + x : 1.0 - x; /* triangle */
      if (tw < 0) tw = 0;
      weights[i] = tw;
      wsum += tw;
    }
    for (int i = 0; i < n; i++) weights[i] /= wsum;
    for (int y = 0; y < ch; y++) {
      const unsigned char *row = src + (size_t)(cy + y) * stride;
      double r = 0, g = 0, b = 0;
      for (int i = 0; i < n; i++) {
        const unsigned char *p = row + (size_t)(xmin + i) * 3;
        r += weights[i] * p[0];
        g += weights[i] * p[1];
        b += weights[i] * p[2];
      }
      float *q = tmp + ((size_t)y * dw + ox) * 3;
      q[0] = (float)r;
      q[1] = (float)g;
      q[2] = (float)b;
    }
  }

  /* vertical pass: (ch, dw) -> (dh, dw) */
  double yscale = (double)ch / dh;
  double ysupport = yscale > 1.0 ? yscale : 1.0;
  for (int oy = 0; oy < dh; oy++) {
    double center = (oy + 0.5) * yscale;
    int ymin = (int)(center - ysupport + 0.5);
    int ymax = (int)(center + ysupport + 0.5);
    if (ymin < 0) ymin = 0;
    if (ymax > ch) ymax = ch;
    double wsum = 0.0, weights[512];
    int n = ymax - ymin;
    if (n > 512) { free(tmp); return 3; }
    for (int i = 0; i < n; i++) {
      double y = (ymin + i + 0.5 - center) / ysupport;
      double tw = y < 0 ? 1.0 + y : 1.0 - y;
      if (tw < 0) tw = 0;
      weights[i] = tw;
      wsum += tw;
    }
    for (int i = 0; i < n; i++) weights[i] /= wsum;
    for (int ox = 0; ox < dw; ox++) {
      double r = 0, g = 0, b = 0;
      for (int i = 0; i < n; i++) {
        const float *p = tmp + (((size_t)(ymin + i)) * dw + ox) * 3;
        r += weights[i] * p[0];
        g += weights[i] * p[1];
        b += weights[i] * p[2];
      }
      float *q = dst + ((size_t)oy * dw + ox) * 3;
      q[0] = (float)r;
      q[1] = (float)g;
      q[2] = (float)b;
    }
  }
  free(tmp);
  return 0;
}

/* One-call hot path: decode, central-crop window, resample to (dw, dh)
 * float32 RGB.  crop_frac <= 0 means no crop (full frame).  Matches
 * native_pipeline._decode_train / _decode_eval. */
int ddlt_jpeg_decode_resize(const unsigned char *buf, unsigned long len,
                            double crop_frac, int dw, int dh, float *dst) {
  unsigned char *pixels = NULL;
  int w = 0, h = 0;
  int rc = ddlt_jpeg_decode(buf, len, &pixels, &w, &h);
  if (rc) return rc;
  int cx = 0, cy = 0, cw = w, ch = h;
  if (crop_frac > 0) {
    int crop = (int)((w < h ? w : h) * crop_frac);
    if (crop < 1) crop = 1;
    if (crop > w) crop = w;
    if (crop > h) crop = h;
    cx = (w - crop) / 2;
    cy = (h - crop) / 2;
    cw = crop;
    ch = crop;
  }
  rc = ddlt_resize_bilinear(pixels, w, h, (long)w * 3, cx, cy, cw, ch, dst,
                            dw, dh);
  free(pixels);
  return rc ? 10 + rc : 0;
}
