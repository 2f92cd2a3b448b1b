// Native .klg log decoder of the PyTorch/CUDA port — the decode path of the
// original system's RawLogReader (Tools/RawLogReader.cpp:64-97 + Tools/
// JPEGLoader.h), built by `elasticfusion_tpu_torch/_build.py` with g++ into a
// small shared library that `io/klg.py` drives through ctypes.  Its own copy
// of the reference package's native/klg_decoder.cpp, same C interface.
//
// Format: int32 numFrames, then per frame
//   int64 timestamp_us, int32 depthSize, int32 imageSize,
//   depthSize bytes (zlib uint16[h*w] mm, or raw if depthSize == h*w*2),
//   imageSize bytes (JPEG, or raw u8[h*w*3] if imageSize == h*w*3; 0 = none).
//
// The file is mmapped and an offset index is built once, so random access
// (rewind/fastForward) is O(1) and decode is the only per-frame cost.
//
// JPEG colour is decoded by libjpeg, as the original system does, or, built
// with -DEF_KLG_NVJPEG on a machine that has the CUDA toolkit but no libjpeg,
// by the toolkit's nvJPEG: it decodes the Y, Cb and Cr planes on the GPU,
// and the host upsamples the chroma and converts to RGB exactly as libjpeg's
// defaults do (`ycc_to_rgb`: "fancy" triangle upsampling of 4:2:0 chroma,
// jdcolor.c's fixed-point YCbCr->RGB), so the two builds differ only where
// the inverse DCTs round differently.  Other subsamplings take nvJPEG's own
// RGB output.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#ifdef EF_KLG_NVJPEG
#include <cuda_runtime_api.h>
#include <nvjpeg.h>
#else
#include <jpeglib.h>
#endif
#include <zlib.h>

namespace {

struct KlgFile {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  int width = 0;
  int height = 0;
  int32_t num_frames = 0;
  std::vector<size_t> offsets;  // offset of each frame header
#ifdef EF_KLG_NVJPEG
  nvjpegHandle_t nv = nullptr;
  nvjpegJpegState_t nv_state = nullptr;
  unsigned char* d_rgb = nullptr;  // device buffer of one decoded frame
  size_t d_bytes = 0;
#endif
};

struct FrameHeader {
  int64_t timestamp;
  int32_t depth_size;
  int32_t image_size;
};

bool read_header(const KlgFile* f, size_t off, FrameHeader* h) {
  if (off + 16 > f->size) return false;
  std::memcpy(&h->timestamp, f->data + off, 8);
  std::memcpy(&h->depth_size, f->data + off + 8, 4);
  std::memcpy(&h->image_size, f->data + off + 12, 4);
  if (h->depth_size < 0 || h->image_size < 0) return false;
  if (off + 16 + (size_t)h->depth_size + (size_t)h->image_size > f->size)
    return false;
  return true;
}

// libjpeg's YCbCr->RGB (jdcolor.c ycc_rgb_convert): 16-bit fixed point,
// Cb/Cr centred on 128, each channel clamped to [0, 255].
inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

void ycc_pixel(int y, int cb, int cr, uint8_t* rgb) {
  const int64_t half = int64_t(1) << 15;
  const int64_t fr = 91881, fbb = 116130, fgr = 46802, fgb = 22554;  // FIX(1.402) ...
  const int x_cr = cr - 128, x_cb = cb - 128;
  const int r = (int)((fr * x_cr + half) >> 16);
  const int b = (int)((fbb * x_cb + half) >> 16);
  const int g = (int)((-fgb * x_cb + half - fgr * x_cr) >> 16);
  rgb[0] = clamp255(y + r);
  rgb[1] = clamp255(y + g);
  rgb[2] = clamp255(y + b);
}

// One chroma plane upsampled 2x2 as libjpeg's h2v2_fancy_upsample does
// (jdsample.c): vertically 3/4 nearer + 1/4 farther row (the image's edge
// rows repeated), horizontally 3/4 + 1/4 with the rounding biases 8 and 7.
void fancy_h2v2(const uint8_t* in, size_t pitch, int cw, int ch, int width,
                int height, uint8_t* out) {
  std::vector<int> sum(cw);
  for (int oy = 0; oy < height; oy++) {
    const int r = oy >> 1;
    const int r2 = (oy & 1) ? (r + 1 < ch ? r + 1 : ch - 1) : (r > 0 ? r - 1 : 0);
    const uint8_t* p0 = in + (size_t)r * pitch;
    const uint8_t* p1 = in + (size_t)r2 * pitch;
    for (int c = 0; c < cw; c++) sum[c] = p0[c] * 3 + p1[c];
    uint8_t* o = out + (size_t)oy * width;
    for (int c = 0; c < cw; c++) {
      const int last = c > 0 ? sum[c - 1] : -1;
      const int next = c + 1 < cw ? sum[c + 1] : -1;
      const int even = last < 0 ? (sum[c] * 4 + 8) >> 4 : (sum[c] * 3 + last + 8) >> 4;
      const int odd = next < 0 ? (sum[c] * 4 + 7) >> 4 : (sum[c] * 3 + next + 7) >> 4;
      if (2 * c < width) o[2 * c] = (uint8_t)even;
      if (2 * c + 1 < width) o[2 * c + 1] = (uint8_t)odd;
    }
  }
}

}  // namespace

extern "C" {

// The colour stage of the nvJPEG path on decoded planes: Y (width x height)
// and Cb, Cr (cw x ch, each pitch bytes a row; cw x ch = width x height
// for 4:4:4, or half of each, rounded up, for 4:2:0) -> RGB.  Exported so
// that it can be held against libjpeg on a host that has libjpeg.  Returns
// 0, or -1 for another subsampling.
int ef_klg_ycc_to_rgb(const uint8_t* y, size_t y_pitch, const uint8_t* cb,
                      const uint8_t* cr, size_t c_pitch, int cw, int ch,
                      int width, int height, uint8_t* rgb_out) {
  std::vector<uint8_t> up_cb, up_cr;
  const uint8_t *pb = cb, *pr = cr;
  size_t pitch = c_pitch;
  if (cw == (width + 1) / 2 && ch == (height + 1) / 2 && (cw != width || ch != height)) {
    up_cb.resize((size_t)width * height);
    up_cr.resize((size_t)width * height);
    fancy_h2v2(cb, c_pitch, cw, ch, width, height, up_cb.data());
    fancy_h2v2(cr, c_pitch, cw, ch, width, height, up_cr.data());
    pb = up_cb.data();
    pr = up_cr.data();
    pitch = (size_t)width;
  } else if (cw != width || ch != height) {
    return -1;
  }
  for (int v = 0; v < height; v++)
    for (int u = 0; u < width; u++)
      ycc_pixel(y[(size_t)v * y_pitch + u], pb[(size_t)v * pitch + u],
                pr[(size_t)v * pitch + u], rgb_out + ((size_t)v * width + u) * 3);
  return 0;
}

}  // extern "C"

namespace {

#ifdef EF_KLG_NVJPEG

// Decode a JPEG buffer into rgb_out (h*w*3, RGB) with nvJPEG. Returns 0 on
// success.
int decode_jpeg(KlgFile* f, const uint8_t* buf, size_t len, int width,
                int height, uint8_t* rgb_out) {
  if (!f->nv) {
    if (nvjpegCreateSimple(&f->nv) != NVJPEG_STATUS_SUCCESS) {
      f->nv = nullptr;
      return -6;
    }
    if (nvjpegJpegStateCreate(f->nv, &f->nv_state) != NVJPEG_STATUS_SUCCESS) {
      f->nv_state = nullptr;
      return -6;
    }
  }
  int n_comp = 0;
  nvjpegChromaSubsampling_t sub;
  int w[NVJPEG_MAX_COMPONENT], h[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(f->nv, buf, len, &n_comp, &sub, w, h) !=
      NVJPEG_STATUS_SUCCESS)
    return -2;
  if (w[0] != width || h[0] != height) return -3;
  const bool ycc = n_comp == 3 && (sub == NVJPEG_CSS_420 || sub == NVJPEG_CSS_444);
  const size_t bytes = (size_t)width * height * 3;
  if (f->d_bytes < bytes) {
    if (f->d_rgb) cudaFree(f->d_rgb);
    f->d_rgb = nullptr;
    f->d_bytes = 0;
    if (cudaMalloc((void**)&f->d_rgb, bytes) != cudaSuccess) return -6;
    f->d_bytes = bytes;
  }
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  if (!ycc) {
    img.channel[0] = f->d_rgb;
    img.pitch[0] = (size_t)width * 3;
    if (nvjpegDecode(f->nv, f->nv_state, buf, len, NVJPEG_OUTPUT_RGBI, &img, 0) !=
        NVJPEG_STATUS_SUCCESS)
      return -1;
    // a copy on the legacy default stream waits for the decode on it
    return cudaMemcpy(rgb_out, f->d_rgb, bytes, cudaMemcpyDeviceToHost) == cudaSuccess
               ? 0 : -1;
  }
  // the three planes packed in the device buffer (chroma at most full size)
  const size_t ny = (size_t)width * height, nc = (size_t)w[1] * h[1];
  img.channel[0] = f->d_rgb;
  img.channel[1] = f->d_rgb + ny;
  img.channel[2] = f->d_rgb + ny + nc;
  img.pitch[0] = (size_t)width;
  img.pitch[1] = img.pitch[2] = (size_t)w[1];
  if (nvjpegDecode(f->nv, f->nv_state, buf, len, NVJPEG_OUTPUT_YUV, &img, 0) !=
      NVJPEG_STATUS_SUCCESS)
    return -1;
  std::vector<uint8_t> planes(ny + 2 * nc);
  if (cudaMemcpy(planes.data(), f->d_rgb, planes.size(), cudaMemcpyDeviceToHost) !=
      cudaSuccess)
    return -1;
  return ef_klg_ycc_to_rgb(planes.data(), width, planes.data() + ny,
                           planes.data() + ny + nc, w[1], w[1], h[1], width, height,
                           rgb_out);
}

void release_decoder(KlgFile* f) {
  if (f->d_rgb) cudaFree(f->d_rgb);
  if (f->nv_state) nvjpegJpegStateDestroy(f->nv_state);
  if (f->nv) nvjpegDestroy(f->nv);
}

#else

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG buffer into rgb_out (h*w*3, RGB). Returns 0 on success.
int decode_jpeg(KlgFile*, const uint8_t* buf, size_t len, int width,
                int height, uint8_t* rgb_out) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_width != width || (int)cinfo.output_height != height) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb_out + (size_t)cinfo.output_scanline * width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

void release_decoder(KlgFile*) {}

#endif  // EF_KLG_NVJPEG

}  // namespace

extern "C" {

// Returns an opaque handle, or null on failure.
void* ef_klg_open(const char* path, int width, int height) {
  KlgFile* f = new KlgFile();
  f->width = width;
  f->height = height;
  f->fd = open(path, O_RDONLY);
  if (f->fd < 0) { delete f; return nullptr; }
  struct stat st;
  if (fstat(f->fd, &st) != 0 || st.st_size < 4) {
    close(f->fd); delete f; return nullptr;
  }
  f->size = (size_t)st.st_size;
  f->data = (const uint8_t*)mmap(nullptr, f->size, PROT_READ, MAP_PRIVATE, f->fd, 0);
  if (f->data == MAP_FAILED) { close(f->fd); delete f; return nullptr; }
  std::memcpy(&f->num_frames, f->data, 4);
  // index all frame offsets up front
  size_t off = 4;
  f->offsets.reserve(f->num_frames > 0 ? f->num_frames : 0);
  for (int32_t i = 0; i < f->num_frames; i++) {
    FrameHeader h;
    if (!read_header(f, off, &h)) break;
    f->offsets.push_back(off);
    off += 16 + (size_t)h.depth_size + (size_t)h.image_size;
  }
  f->num_frames = (int32_t)f->offsets.size();
  return f;
}

int ef_klg_num_frames(void* handle) {
  return handle ? ((KlgFile*)handle)->num_frames : -1;
}

// Decode frame `idx` into caller-provided buffers. depth_out: h*w uint16,
// rgb_out: h*w*3 uint8, ts_out: int64. Returns 0 on success.
int ef_klg_read(void* handle, int idx, uint16_t* depth_out, uint8_t* rgb_out,
                int64_t* ts_out) {
  if (!handle) return -1;
  KlgFile* f = (KlgFile*)handle;
  if (idx < 0 || idx >= f->num_frames) return -2;
  FrameHeader h;
  if (!read_header(f, f->offsets[idx], &h)) return -3;
  *ts_out = h.timestamp;
  const uint8_t* depth_buf = f->data + f->offsets[idx] + 16;
  const uint8_t* image_buf = depth_buf + h.depth_size;
  const size_t n_px = (size_t)f->width * f->height;

  if ((size_t)h.depth_size == n_px * 2) {
    std::memcpy(depth_out, depth_buf, n_px * 2);
  } else {
    uLongf dest_len = n_px * 2;
    if (uncompress((Bytef*)depth_out, &dest_len, depth_buf, h.depth_size) != Z_OK ||
        dest_len != n_px * 2)
      return -4;
  }

  if ((size_t)h.image_size == n_px * 3) {
    std::memcpy(rgb_out, image_buf, n_px * 3);
  } else if (h.image_size > 0) {
    if (decode_jpeg(f, image_buf, h.image_size, f->width, f->height, rgb_out) != 0)
      return -5;
  } else {
    std::memset(rgb_out, 0, n_px * 3);
  }
  return 0;
}

void ef_klg_close(void* handle) {
  if (!handle) return;
  KlgFile* f = (KlgFile*)handle;
  release_decoder(f);
  munmap((void*)f->data, f->size);
  close(f->fd);
  delete f;
}

}  // extern "C"
