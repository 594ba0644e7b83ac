// Native IO runtime of bwd_nlkalman_tpu_torch: the port's own copy of
// bwd_nlkalman_tpu/native/bnlk_io.cpp, with the same C ABI and the same
// decode and encode arithmetic.
//
// The reference's runtime layer is C (the vendored iio library,
// lib/iio/iio.c, plus file-based bash orchestration).  This is its
// counterpart: float-image codecs (PNG via libpng, TIFF via libtiff, JPEG
// via libjpeg, PFM and Middlebury FLO hand-rolled) plus a multi-threaded
// frame-sequence prefetcher, exposed as a C ABI consumed through ctypes.
//
// Each library codec sits behind a guard (BNLK_HAVE_PNG, BNLK_HAVE_TIFF,
// BNLK_HAVE_JPEG) that native/__init__.py defines where the
// compiler finds the codec's header, so a machine that lacks one still
// builds the others. An entry of a codec left out returns failure (-1 or
// nullptr); bnlk_codecs() reports which were compiled in.
//
// All decoders return newly-allocated float32 HWC buffers (row-major,
// interleaved channels), matching the iio float API conventions
// (lib/iio/iio.h:33-60).

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <cmath>
#include <string>
#include <vector>
#include <thread>
#include <mutex>
#include <condition_variable>
#include <queue>

#include <csetjmp>
#ifdef BNLK_HAVE_PNG
#include <png.h>
#endif
#ifdef BNLK_HAVE_TIFF
#include <tiffio.h>
#endif
#ifdef BNLK_HAVE_JPEG
#include <jpeglib.h>
#endif

#ifdef BNLK_HAVE_TIFF
static struct TiffQuiet {
  TiffQuiet() { TIFFSetWarningHandler(nullptr); }
} tiff_quiet_;
#endif

extern "C" {

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

void bnlk_free(void *p) { free(p); }

// The codecs compiled in: bit 0 PNG, bit 1 TIFF, bit 2 JPEG.
int bnlk_codecs(void) {
  int m = 0;
#ifdef BNLK_HAVE_PNG
  m |= 1;
#endif
#ifdef BNLK_HAVE_TIFF
  m |= 2;
#endif
#ifdef BNLK_HAVE_JPEG
  m |= 4;
#endif
  return m;
}

static bool has_suffix(const char *path, const char *suf) {
  size_t lp = strlen(path), ls = strlen(suf);
  if (ls > lp) return false;
  for (size_t i = 0; i < ls; i++)
    if (tolower(path[lp - ls + i]) != suf[i]) return false;
  return true;
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

#ifdef BNLK_HAVE_PNG
static float *read_png_f32(const char *path, int *w, int *h, int *c) {
  FILE *f = fopen(path, "rb");
  if (!f) return nullptr;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return nullptr;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 width, height;
  int depth, color;
  png_get_IHDR(png, info, &width, &height, &depth, &color, nullptr, nullptr, nullptr);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);
  int nch = png_get_channels(png, info);
  depth = png_get_bit_depth(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<uint8_t> raw(rowbytes * height);
  std::vector<png_bytep> rows(height);
  for (png_uint_32 y = 0; y < height; y++) rows[y] = raw.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);

  float *out = (float *)malloc(sizeof(float) * width * height * nch);
  if (depth == 16) {
    for (size_t i = 0; i < (size_t)width * height * nch; i++)
      out[i] = (float)((raw[2 * i] << 8) | raw[2 * i + 1]);
  } else {
    for (size_t i = 0; i < (size_t)width * height * nch; i++)
      out[i] = (float)raw[i];
  }
  *w = width; *h = height; *c = nch;
  return out;
}

int bnlk_write_png(const char *path, const float *data, int w, int h, int c,
                   int depth) {
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(f);
    return -1;
  }
  png_init_io(png, f);
  int color = (c == 1) ? PNG_COLOR_TYPE_GRAY
            : (c == 2) ? PNG_COLOR_TYPE_GRAY_ALPHA
            : (c == 3) ? PNG_COLOR_TYPE_RGB : PNG_COLOR_TYPE_RGBA;
  png_set_IHDR(png, info, w, h, depth, color, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  if (depth == 8) {
    std::vector<uint8_t> row(w * c);
    for (int y = 0; y < h; y++) {
      for (int i = 0; i < w * c; i++) {
        float v = nearbyintf(data[(size_t)y * w * c + i]);
        row[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
      }
      png_write_row(png, row.data());
    }
  } else {
    std::vector<uint8_t> row(w * c * 2);
    for (int y = 0; y < h; y++) {
      for (int i = 0; i < w * c; i++) {
        float v = nearbyintf(data[(size_t)y * w * c + i]);
        uint16_t u = (uint16_t)(v < 0 ? 0 : v > 65535 ? 65535 : v);
        row[2 * i] = u >> 8;
        row[2 * i + 1] = u & 0xff;
      }
      png_write_row(png, row.data());
    }
  }
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  fclose(f);
  return 0;
}
#else
static float *read_png_f32(const char *, int *, int *, int *) { return nullptr; }

int bnlk_write_png(const char *, const float *, int, int, int, int) { return -1; }
#endif

// ---------------------------------------------------------------------------
// TIFF (float32 and integer, via libtiff; reads classic + BigTIFF)
// ---------------------------------------------------------------------------

#ifdef BNLK_HAVE_TIFF
static float *read_tiff_f32(const char *path, int *w, int *h, int *c) {
  TIFF *tif = TIFFOpen(path, "r");
  if (!tif) return nullptr;
  uint32_t width = 0, height = 0;
  uint16_t spp = 1, bps = 8, fmt = SAMPLEFORMAT_UINT;
  TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &width);
  TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &height);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &spp);
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &bps);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLEFORMAT, &fmt);
  float *out = (float *)malloc(sizeof(float) * width * height * spp);
  tmsize_t sls = TIFFScanlineSize(tif);
  std::vector<uint8_t> buf(sls);
  for (uint32_t y = 0; y < height; y++) {
    if (TIFFReadScanline(tif, buf.data(), y) < 0) {
      free(out); TIFFClose(tif); return nullptr;
    }
    float *dst = out + (size_t)y * width * spp;
    if (fmt == SAMPLEFORMAT_IEEEFP && bps == 32)
      memcpy(dst, buf.data(), sizeof(float) * width * spp);
    else if (bps == 8)
      for (uint32_t i = 0; i < width * spp; i++) dst[i] = buf[i];
    else if (bps == 16) {
      const uint16_t *s = (const uint16_t *)buf.data();
      for (uint32_t i = 0; i < width * spp; i++) dst[i] = s[i];
    } else { free(out); TIFFClose(tif); return nullptr; }
  }
  TIFFClose(tif);
  *w = width; *h = height; *c = spp;
  return out;
}

int bnlk_write_tiff(const char *path, const float *data, int w, int h, int c) {
  TIFF *tif = TIFFOpen(path, "w");
  if (!tif) return -1;
  TIFFSetField(tif, TIFFTAG_IMAGEWIDTH, (uint32_t)w);
  TIFFSetField(tif, TIFFTAG_IMAGELENGTH, (uint32_t)h);
  TIFFSetField(tif, TIFFTAG_SAMPLESPERPIXEL, (uint16_t)c);
  TIFFSetField(tif, TIFFTAG_BITSPERSAMPLE, (uint16_t)32);
  TIFFSetField(tif, TIFFTAG_SAMPLEFORMAT, SAMPLEFORMAT_IEEEFP);
  TIFFSetField(tif, TIFFTAG_PHOTOMETRIC,
               c >= 3 ? PHOTOMETRIC_RGB : PHOTOMETRIC_MINISBLACK);
  TIFFSetField(tif, TIFFTAG_PLANARCONFIG, PLANARCONFIG_CONTIG);
  TIFFSetField(tif, TIFFTAG_ROWSPERSTRIP, (uint32_t)h);
  for (int y = 0; y < h; y++)
    if (TIFFWriteScanline(tif, (void *)(data + (size_t)y * w * c), y) < 0) {
      TIFFClose(tif); return -1;
    }
  TIFFClose(tif);
  return 0;
}
#else
static float *read_tiff_f32(const char *, int *, int *, int *) { return nullptr; }

int bnlk_write_tiff(const char *, const float *, int, int, int) { return -1; }
#endif

// ---------------------------------------------------------------------------
// PFM / FLO (iio row conventions: top-down, no flip)
// ---------------------------------------------------------------------------

static float *read_pfm_f32(const char *path, int *w, int *h, int *c) {
  FILE *f = fopen(path, "rb");
  if (!f) return nullptr;
  char hdr[3] = {0};
  float scale;
  if (fscanf(f, "%2s %d %d %f", hdr, w, h, &scale) != 4) { fclose(f); return nullptr; }
  fgetc(f);
  *c = (hdr[1] == 'F') ? 3 : 1;
  size_t n = (size_t)(*w) * (*h) * (*c);
  float *out = (float *)malloc(sizeof(float) * n);
  if (fread(out, sizeof(float), n, f) != n) { free(out); fclose(f); return nullptr; }
  fclose(f);
  return out;
}

int bnlk_write_pfm(const char *path, const float *data, int w, int h, int c) {
  if (c != 1 && c != 3) return -1;
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "%s\n%d %d\n-1.0\n", c == 3 ? "PF" : "Pf", w, h);
  fwrite(data, sizeof(float), (size_t)w * h * c, f);
  fclose(f);
  return 0;
}

static float *read_flo_f32(const char *path, int *w, int *h, int *c) {
  FILE *f = fopen(path, "rb");
  if (!f) return nullptr;
  float magic;
  int ww, hh;
  if (fread(&magic, 4, 1, f) != 1 || fabsf(magic - 202021.25f) > 1e-3f) {
    fclose(f); return nullptr;
  }
  if (fread(&ww, 4, 1, f) != 1 || fread(&hh, 4, 1, f) != 1) { fclose(f); return nullptr; }
  size_t n = (size_t)ww * hh * 2;
  float *out = (float *)malloc(sizeof(float) * n);
  if (fread(out, 4, n, f) != n) { free(out); fclose(f); return nullptr; }
  fclose(f);
  *w = ww; *h = hh; *c = 2;
  return out;
}

int bnlk_write_flo(const char *path, const float *data, int w, int h) {
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  float magic = 202021.25f;
  fwrite(&magic, 4, 1, f);
  fwrite(&w, 4, 1, f);
  fwrite(&h, 4, 1, f);
  fwrite(data, 4, (size_t)w * h * 2, f);
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG (iio reads JPEG via I_CAN_HAS_LIBJPEG, lib/iio/iio.c:30,1399-1450)
// ---------------------------------------------------------------------------

#ifdef BNLK_HAVE_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr *>(cinfo->err)->jb, 1);
}

static float *read_jpeg_f32(const char *path, int *w, int *h, int *c) {
  FILE *f = fopen(path, "rb");
  if (!f) return nullptr;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  float *out = nullptr;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    free(out);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  jpeg_start_decompress(&cinfo);
  *w = (int)cinfo.output_width;
  *h = (int)cinfo.output_height;
  *c = (int)cinfo.output_components;
  out = (float *)malloc((size_t)*w * *h * *c * sizeof(float));
  std::vector<JSAMPLE> row((size_t)*w * *c);
  JSAMPROW rp = row.data();
  while (cinfo.output_scanline < cinfo.output_height) {
    int y = (int)cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float *dst = out + (size_t)y * *w * *c;
    for (size_t i = 0; i < (size_t)*w * *c; i++) dst[i] = (float)row[i];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return out;
}

int bnlk_write_jpeg(const char *path, const float *data, int w, int h, int c,
                    int quality) {
  if (c != 1 && c != 3) return -1;
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    fclose(f);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = c;
  cinfo.in_color_space = c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality > 0 ? quality : 95, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  std::vector<JSAMPLE> row((size_t)w * c);
  JSAMPROW rp = row.data();
  while (cinfo.next_scanline < cinfo.image_height) {
    const float *src = data + (size_t)cinfo.next_scanline * w * c;
    for (size_t i = 0; i < (size_t)w * c; i++) {
      float v = src[i];
      row[i] = (JSAMPLE)(v < 0 ? 0 : v > 255 ? 255 : (int)(v + 0.5f));
    }
    jpeg_write_scanlines(&cinfo, &rp, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(f);
  return 0;
}
#else
static float *read_jpeg_f32(const char *, int *, int *, int *) { return nullptr; }

int bnlk_write_jpeg(const char *, const float *, int, int, int, int) { return -1; }
#endif

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

float *bnlk_read_image(const char *path, int *w, int *h, int *c) {
  if (has_suffix(path, ".png")) return read_png_f32(path, w, h, c);
  if (has_suffix(path, ".tif") || has_suffix(path, ".tiff"))
    return read_tiff_f32(path, w, h, c);
  if (has_suffix(path, ".pfm")) return read_pfm_f32(path, w, h, c);
  if (has_suffix(path, ".flo")) return read_flo_f32(path, w, h, c);
  if (has_suffix(path, ".jpg") || has_suffix(path, ".jpeg"))
    return read_jpeg_f32(path, w, h, c);
  return nullptr;
}

// ---------------------------------------------------------------------------
// threaded frame prefetcher (the data-loader runtime)
// ---------------------------------------------------------------------------

struct Frame {
  int index;
  int w, h, c;
  float *data;  // nullptr on read failure
};

struct Loader {
  std::vector<std::string> paths;
  std::queue<Frame> ready;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> workers;
  size_t next_submit = 0;
  size_t next_emit = 0;
  size_t max_queue;
  bool stop = false;
  std::vector<Frame> stash;  // out-of-order completions

  ~Loader() {
    {
      std::lock_guard<std::mutex> g(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto &t : workers) t.join();
    std::lock_guard<std::mutex> g(mu);
    while (!ready.empty()) { free(ready.front().data); ready.pop(); }
    for (auto &f : stash) free(f.data);
  }
};

void *bnlk_loader_create(const char *pattern, int first, int last, int step,
                         int nthreads, int max_queue) {
  Loader *L = new Loader();
  char buf[4096];
  for (int i = first; i <= last; i += step) {
    snprintf(buf, sizeof(buf), pattern, i);
    L->paths.emplace_back(buf);
  }
  L->max_queue = max_queue > 0 ? max_queue : 4;
  if (nthreads <= 0) nthreads = 2;
  for (int t = 0; t < nthreads; t++) {
    L->workers.emplace_back([L]() {
      for (;;) {
        size_t idx;
        {
          std::unique_lock<std::mutex> lk(L->mu);
          L->cv.wait(lk, [L] {
            return L->stop || (L->next_submit < L->paths.size() &&
                               L->ready.size() + L->stash.size() < L->max_queue);
          });
          if (L->stop) return;
          idx = L->next_submit++;
        }
        Frame f;
        f.index = (int)idx;
        f.data = bnlk_read_image(L->paths[idx].c_str(), &f.w, &f.h, &f.c);
        {
          std::lock_guard<std::mutex> g(L->mu);
          L->stash.push_back(f);
          // emit in order
          bool moved = true;
          while (moved) {
            moved = false;
            for (size_t i = 0; i < L->stash.size(); i++)
              if ((size_t)L->stash[i].index == L->next_emit) {
                L->ready.push(L->stash[i]);
                L->stash.erase(L->stash.begin() + i);
                L->next_emit++;
                moved = true;
                break;
              }
          }
        }
        L->cv.notify_all();
      }
    });
  }
  return L;
}

// Blocks until the next in-order frame is decoded; returns its buffer (caller
// frees with bnlk_free) or nullptr at end of sequence / on failure.
float *bnlk_loader_next(void *loader, int *index, int *w, int *h, int *c) {
  Loader *L = (Loader *)loader;
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_emit >= L->paths.size() && L->ready.empty()) return nullptr;
  L->cv.wait(lk, [L] { return !L->ready.empty(); });
  Frame f = L->ready.front();
  L->ready.pop();
  lk.unlock();
  L->cv.notify_all();
  *index = f.index; *w = f.w; *h = f.h; *c = f.c;
  return f.data;
}

void bnlk_loader_destroy(void *loader) { delete (Loader *)loader; }

}  // extern "C"
