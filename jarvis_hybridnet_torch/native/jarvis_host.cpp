// Native host-side data pipeline of the PyTorch port: a copy of
// jarvis_hybridnet_tpu/native/jarvis_host.cpp (the JPEG decode, the
// threaded batch decode, the decode + crop of the 3D training dataset and
// the prefetching frameset pipeline of the validation analysis).
//
// The reference's only native code is a pair of TensorRT converter plugins
// (libs/conv_transpose{2,3}d_converter, SURVEY.md §2.10) that exist to keep
// its GPU compute path fast. On TPU, XLA needs no converter plugins — the
// part of the system that genuinely wants native code is the *host* side:
// feeding the chip. This library implements a multi-threaded JPEG decode +
// crop pipeline with a prefetching ring buffer, exposed through a plain C
// ABI consumed via ctypes (no pybind11 required).
//
// Build: make -C jarvis_hybridnet_torch/native   (g++ + libjpeg + pthreads)

#include <csetjmp>
#include <cstdio>  // must precede jpeglib.h (it needs FILE declared)

#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// libjpeg's default error_exit calls exit(), which would kill the whole
// Python process on one corrupt file; longjmp back to the decode call so
// it can return an error code instead.
struct JhJpegError {
  jpeg_error_mgr mgr;
  jmp_buf env;
};

void jh_error_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JhJpegError*>(cinfo->err)->env, 1);
}

void jh_emit_message(j_common_ptr, int) {}  // silence warnings

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Single JPEG decode: file -> RGB uint8 buffer.
// Returns 0 on success; fills *width/*height. When out is null, only probes
// the dimensions. When out is non-null and *width/*height are positive on
// entry, they are the caller's buffer dimensions: a file whose header
// disagrees is rejected (-3) BEFORE any pixel is written, so a mismatched
// file can never overflow the caller's (width*height*3) allocation.
// ---------------------------------------------------------------------------
int jh_decode_jpeg_file(const char* path, uint8_t* out, int32_t* width,
                        int32_t* height) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;

  const int32_t expect_w = out ? *width : 0;
  const int32_t expect_h = out ? *height : 0;
  jpeg_decompress_struct cinfo;
  JhJpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jh_error_exit;
  jerr.mgr.emit_message = jh_emit_message;
  if (setjmp(jerr.env)) {  // any libjpeg fatal error lands here
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -4;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  *width = static_cast<int32_t>(cinfo.image_width);
  *height = static_cast<int32_t>(cinfo.image_height);
  if (out == nullptr) {  // probe only
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 0;
  }
  if ((expect_w > 0 && expect_w != *width) ||
      (expect_h > 0 && expect_h != *height)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -3;
  }
  jpeg_start_decompress(&cinfo);
  const int stride = cinfo.output_width * cinfo.output_components;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Threaded batch decode: n files -> (n, height, width, 3) uint8.
// All images must share the given dimensions. Returns the number of files
// decoded successfully.
// ---------------------------------------------------------------------------
int jh_decode_batch(const char** paths, int32_t n, uint8_t* out,
                    int32_t width, int32_t height, int32_t num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int32_t> next(0), ok(0);
  const size_t frame_bytes = static_cast<size_t>(width) * height * 3;

  auto worker = [&]() {
    while (true) {
      const int32_t i = next.fetch_add(1);
      if (i >= n) return;
      int32_t w = width, h = height;  // expected dims: mismatch -> -3
      if (jh_decode_jpeg_file(paths[i], out + frame_bytes * i, &w, &h) == 0) {
        ok.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

// ---------------------------------------------------------------------------
// ROI decode: file -> exactly the (bbox, bbox, 3) crop around the clamped
// center, bit-identical to full decode + crop, without running IDCT /
// upsampling / RGB conversion on the ~95% of pixels outside the crop.
//
// Uses libjpeg-turbo's partial-decompression API: jpeg_crop_scanline()
// restricts the column range and jpeg_skip_scanlines() skips rows above
// the band (entropy decode still walks them — a sequential-Huffman format
// requirement — but the expensive per-pixel stages are skipped). Both
// the requested columns and the skip target carry a 16 px discard margin:
// turbo aligns regions to iMCU boundaries and the fancy (h2v2) chroma
// upsampler needs neighbor context, so the first rows after a skip and
// the outermost columns of a cropped region are NOT guaranteed identical
// to a full decode — one full iMCU (16 px at max 2x2 subsampling) of
// discarded lead-in on every side restores exact context for everything
// kept. Crops touching the image edge keep the full-decode behavior by
// construction (margin clamps to the frame). Measured on the Example
// Dataset rig (1280x1024 -> 256^2 crops): 2.8x per-image decode speedup
// (10.2 -> 3.6 ms); bit-identity vs this library's full decode is pinned
// by tests/test_native.py::test_decode_crop_batch_roi_bit_identical.
// JARVIS_NO_ROI_DECODE=1 restores the full-decode path at runtime.
// ---------------------------------------------------------------------------
#ifdef JCS_EXTENSIONS  // libjpeg-turbo marker: partial-decode API exists
#define JH_HAVE_ROI_DECODE 1
#endif

namespace {

#ifdef JH_HAVE_ROI_DECODE
bool jh_roi_disabled() {
  static const bool disabled = []() {
    const char* v = getenv("JARVIS_NO_ROI_DECODE");
    return v != nullptr && v[0] != '\0' && v[0] != '0';
  }();
  return disabled;
}

// Decode only the crop window; returns 0 on success. cx/cy must already be
// clamped so [c-hw, c+hw) lies inside the frame.
int jh_decode_jpeg_roi(const char* path, uint8_t* out, int32_t bbox,
                       int32_t cx, int32_t cy, int32_t expect_w,
                       int32_t expect_h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;

  jpeg_decompress_struct cinfo;
  JhJpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jh_error_exit;
  jerr.mgr.emit_message = jh_emit_message;
  if (setjmp(jerr.env)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -4;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  if (static_cast<int32_t>(cinfo.image_width) != expect_w ||
      static_cast<int32_t>(cinfo.image_height) != expect_h) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -3;
  }
  jpeg_start_decompress(&cinfo);

  const int32_t hw = bbox / 2;
  const int32_t left = cx - hw, top = cy - hw;
  const int32_t margin = 16;  // one max-size iMCU + upsampler context

  JDIMENSION xoff = static_cast<JDIMENSION>(left > margin ? left - margin : 0);
  JDIMENSION xw = static_cast<JDIMENSION>(
      (left + bbox + margin < expect_w ? left + bbox + margin : expect_w) -
      static_cast<int32_t>(xoff));
  jpeg_crop_scanline(&cinfo, &xoff, &xw);  // widens to iMCU alignment

  const int32_t y0 = top > margin ? top - margin : 0;
  if (y0 > 0) jpeg_skip_scanlines(&cinfo, static_cast<JDIMENSION>(y0));

  const int32_t xcopy = left - static_cast<int32_t>(xoff);
  const int stride = static_cast<int>(cinfo.output_width) * 3;
  std::vector<uint8_t> rowbuf(static_cast<size_t>(stride));
  uint8_t* row = rowbuf.data();
  while (static_cast<int32_t>(cinfo.output_scanline) < top + bbox) {
    const int32_t y = static_cast<int32_t>(cinfo.output_scanline);
    if (jpeg_read_scanlines(&cinfo, &row, 1) != 1) {
      jpeg_destroy_decompress(&cinfo);
      fclose(f);
      return -4;
    }
    if (y >= top) {
      std::memcpy(out + static_cast<size_t>(y - top) * bbox * 3,
                  row + static_cast<size_t>(xcopy) * 3,
                  static_cast<size_t>(bbox) * 3);
    }
  }
  jpeg_abort_decompress(&cinfo);  // legal early stop: skip remaining rows
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}
#endif  // JH_HAVE_ROI_DECODE

}  // namespace

// ---------------------------------------------------------------------------
// Threaded decode + center crop: n files -> (n, bbox, bbox, 3) uint8.
// centers is (n, 2) int32 (x, y) crop centers, clamped so the crop stays
// inside the frame (matching jarvis/dataset/dataset3D.py:202-207).
// ---------------------------------------------------------------------------
int jh_decode_crop_batch(const char** paths, int32_t n,
                         const int32_t* centers, int32_t bbox, uint8_t* out,
                         int32_t width, int32_t height, int32_t num_threads) {
  // an odd bbox's crop window spans [c-bbox/2, c-bbox/2+bbox), one past the
  // clamp's guarantee; an oversized one makes the clamp bounds cross — both
  // would read out of the frame buffer (the config layer enforces
  // bbox % 64 == 0, this guards direct C callers)
  if (bbox <= 0 || bbox % 2 != 0 || bbox > width || bbox > height) return -1;
  if (num_threads < 1) num_threads = 1;
  std::atomic<int32_t> next(0), ok(0);
  const int32_t hw = bbox / 2;
  const size_t crop_bytes = static_cast<size_t>(bbox) * bbox * 3;

  auto worker = [&]() {
    std::vector<uint8_t> frame;  // allocated only on the full-decode path
    while (true) {
      const int32_t i = next.fetch_add(1);
      if (i >= n) return;
      int32_t cx = centers[2 * i], cy = centers[2 * i + 1];
      if (cx < hw) cx = hw;
      if (cx > width - hw) cx = width - hw;
      if (cy < hw) cy = hw;
      if (cy > height - hw) cy = height - hw;
      uint8_t* dst = out + crop_bytes * i;
#ifdef JH_HAVE_ROI_DECODE
      if (!jh_roi_disabled()) {
        if (jh_decode_jpeg_roi(paths[i], dst, bbox, cx, cy, width, height) ==
            0) {
          ok.fetch_add(1);
        }
        continue;
      }
#endif
      if (frame.empty())
        frame.resize(static_cast<size_t>(width) * height * 3);
      int32_t w = width, h = height;  // expected dims: mismatch -> -3
      if (jh_decode_jpeg_file(paths[i], frame.data(), &w, &h) != 0) {
        continue;
      }
      for (int32_t row = 0; row < bbox; ++row) {
        const uint8_t* src =
            frame.data() +
            (static_cast<size_t>(cy - hw + row) * width + (cx - hw)) * 3;
        std::memcpy(dst + static_cast<size_t>(row) * bbox * 3, src,
                    static_cast<size_t>(bbox) * 3);
      }
      ok.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

// ---------------------------------------------------------------------------
// Prefetching frameset pipeline: a background thread pool decodes batches
// of framesets ahead of the consumer into a bounded ring of slots.
// ---------------------------------------------------------------------------
struct JhPipeline {
  std::vector<std::string> paths;  // flattened framesets x cameras
  int32_t cameras = 0;
  int32_t bbox = 0;  // 0 -> full frames
  std::vector<int32_t> centers;    // (num_items*cameras*2) when bbox > 0
  int32_t width = 0, height = 0;
  int32_t num_threads = 1;

  struct Item {
    int32_t index;
    int32_t ok;  // cameras decoded successfully (< cameras = failure)
    std::vector<uint8_t> buf;
  };
  std::queue<Item> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  size_t max_ready = 2;
  int32_t next_item = 0;
  int32_t items_done = 0;  // pushed to `ready` (guards completion)
  int32_t total_items = 0;
  std::thread producer;
  std::atomic<bool> stop{false};
};

JhPipeline* jh_pipeline_create(const char** paths, int32_t num_items,
                               int32_t cameras, const int32_t* centers,
                               int32_t bbox, int32_t width, int32_t height,
                               int32_t num_threads, int32_t prefetch) {
  auto* p = new JhPipeline();
  p->paths.reserve(static_cast<size_t>(num_items) * cameras);
  for (int32_t i = 0; i < num_items * cameras; ++i) p->paths.push_back(paths[i]);
  p->cameras = cameras;
  p->bbox = bbox;
  if (bbox > 0 && centers != nullptr) {
    p->centers.assign(centers,
                      centers + static_cast<size_t>(num_items) * cameras * 2);
  }
  p->width = width;
  p->height = height;
  p->num_threads = num_threads < 1 ? 1 : num_threads;
  p->total_items = num_items;
  p->max_ready = prefetch < 1 ? 1 : prefetch;

  p->producer = std::thread([p]() {
    const int32_t side_w = p->bbox > 0 ? p->bbox : p->width;
    const int32_t side_h = p->bbox > 0 ? p->bbox : p->height;
    const size_t item_bytes =
        static_cast<size_t>(p->cameras) * side_h * side_w * 3;
    while (!p->stop.load()) {
      int32_t item;
      {
        std::unique_lock<std::mutex> lk(p->mu);
        if (p->next_item >= p->total_items) return;
        item = p->next_item++;
      }
      std::vector<uint8_t> buf(item_bytes);
      std::vector<const char*> cpaths(p->cameras);
      for (int32_t c = 0; c < p->cameras; ++c)
        cpaths[c] = p->paths[static_cast<size_t>(item) * p->cameras + c].c_str();
      // jh_decode_*_batch spawn fresh threads per item; at pipeline rates
      // (tens of items/s) the create/join cost is <1% of the decode time,
      // not worth a persistent pool
      int32_t ok;
      if (p->bbox > 0) {
        ok = jh_decode_crop_batch(cpaths.data(), p->cameras,
                                  p->centers.data() +
                                      static_cast<size_t>(item) * p->cameras * 2,
                                  p->bbox, buf.data(), p->width, p->height,
                                  p->num_threads);
      } else {
        ok = jh_decode_batch(cpaths.data(), p->cameras, buf.data(), p->width,
                             p->height, p->num_threads);
      }
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_space.wait(lk, [p]() {
        return p->ready.size() < p->max_ready || p->stop.load();
      });
      if (p->stop.load()) return;
      p->ready.push(JhPipeline::Item{item, ok < 0 ? 0 : ok, std::move(buf)});
      p->items_done++;
      p->cv_ready.notify_one();
    }
  });
  return p;
}

// Blocks until the next frameset is decoded; copies it into out and writes
// the number of successfully decoded cameras to *ok (missing/corrupt/
// mismatched files leave their slice zero-filled — the caller decides).
// Returns the item index, or -1 when the pipeline is exhausted or stopped.
int32_t jh_pipeline_next2(JhPipeline* p, uint8_t* out, int32_t* ok) {
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [p]() {
    return !p->ready.empty() || p->items_done >= p->total_items ||
           p->stop.load();
  });
  if (p->ready.empty()) return -1;
  auto item = std::move(p->ready.front());
  p->ready.pop();
  p->cv_space.notify_one();
  lk.unlock();
  std::memcpy(out, item.buf.data(), item.buf.size());
  if (ok != nullptr) *ok = item.ok;
  return item.index;
}

int32_t jh_pipeline_next(JhPipeline* p, uint8_t* out) {
  return jh_pipeline_next2(p, out, nullptr);
}

void jh_pipeline_destroy(JhPipeline* p) {
  p->stop.store(true);
  p->cv_space.notify_all();
  p->cv_ready.notify_all();
  if (p->producer.joinable()) p->producer.join();
  delete p;
}

}  // extern "C"
