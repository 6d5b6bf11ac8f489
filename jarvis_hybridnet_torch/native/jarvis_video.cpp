// Native multi-camera video decode pipeline (libavformat/libavcodec): the
// PyTorch port's copy of jarvis_hybridnet_tpu/native/jarvis_video.cpp.
//
// The reference decodes video with per-frame cv2.VideoCapture reads fanned
// out over joblib threads (jarvis/prediction/predict3D.py:75-101, one frame
// at a time, synchronous with the GPU step). This library instead runs the
// whole multi-camera decode loop in C++ worker threads that demux + decode
// + color-convert every camera stream directly into Python-owned uint8
// ring buffers shaped (T, C, H, W, 3) — the exact batch layout the
// predictors consume — so the host side of the streaming pipeline never
// touches the Python interpreter between batches.
//
// Ring semantics mirror prediction/video_io.MultiCameraReader (bounded
// prefetch; decoders block, not race, when the consumer falls behind).
//
// Build: make -C jarvis_hybridnet_torch/native libjarvis_video.so
//        (g++ + libavformat/libavcodec/libavutil/libswscale + pthreads)

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// libav warns per-stream about the legacy yuvj* pixel formats MJPEG uses;
// the conversion itself is handled correctly by swscale.
struct SilenceAvLog {
  SilenceAvLog() { av_log_set_level(AV_LOG_ERROR); }
} silence_av_log;

// ---------------------------------------------------------------------------
// Single-stream decoder: open -> sequential RGB24 frame reads.
// ---------------------------------------------------------------------------
struct JvDecoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  int stream_idx = -1;
  int width = 0, height = 0;
  int64_t n_frames = 0;   // best-effort total frame count
  int64_t next_index = 0; // index of the next frame jv_read returns
  bool drained = false;
  bool pending = false;   // d->frame holds a decoded, unconsumed frame
  SwsContext* sws_low = nullptr;  // optional second (downscaled) output
};

void decoder_close(JvDecoder* d) {
  if (d->sws_low) sws_freeContext(d->sws_low);
  d->sws_low = nullptr;
  if (d->sws) sws_freeContext(d->sws);
  if (d->frame) av_frame_free(&d->frame);
  if (d->pkt) av_packet_free(&d->pkt);
  if (d->dec) avcodec_free_context(&d->dec);
  if (d->fmt) avformat_close_input(&d->fmt);
  d->sws = nullptr;
}

int decoder_open(JvDecoder* d, const char* path) {
  if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(d->fmt, nullptr) < 0) return -2;
  const AVCodec* codec = nullptr;
  d->stream_idx =
      av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
  if (d->stream_idx < 0 || !codec) return -3;
  AVStream* st = d->fmt->streams[d->stream_idx];
  d->dec = avcodec_alloc_context3(codec);
  if (!d->dec) return -4;
  if (avcodec_parameters_to_context(d->dec, st->codecpar) < 0) return -5;
  // one stream per thread outside; keep the codec single-threaded so N
  // camera threads don't oversubscribe the host N*threads times
  d->dec->thread_count = 1;
  if (avcodec_open2(d->dec, codec, nullptr) < 0) return -6;
  d->width = d->dec->width;
  d->height = d->dec->height;
  d->frame = av_frame_alloc();
  d->pkt = av_packet_alloc();
  d->n_frames = st->nb_frames;
  if (d->n_frames <= 0 && st->duration > 0 &&
      st->avg_frame_rate.num > 0 && st->avg_frame_rate.den > 0) {
    d->n_frames = av_rescale_q(st->duration, st->time_base,
                               av_inv_q(st->avg_frame_rate));
  }
  return 0;
}

// Decode the next frame into d->frame without consuming it.
// Returns 0 on success, 1 on clean end of stream, <0 on error.
int decoder_fetch(JvDecoder* d) {
  if (d->pending) return 0;
  while (true) {
    int ret = avcodec_receive_frame(d->dec, d->frame);
    if (ret == 0) {
      d->pending = true;
      return 0;
    }
    if (ret == AVERROR_EOF) return 1;
    if (ret != AVERROR(EAGAIN)) return -11;
    if (d->drained) return 1;
    // feed the next packet of our stream
    while (true) {
      ret = av_read_frame(d->fmt, d->pkt);
      if (ret == AVERROR_EOF) {
        avcodec_send_packet(d->dec, nullptr);  // enter drain mode
        d->drained = true;
        break;
      }
      if (ret < 0) return -12;
      if (d->pkt->stream_index == d->stream_idx) {
        ret = avcodec_send_packet(d->dec, d->pkt);
        av_packet_unref(d->pkt);
        if (ret < 0 && ret != AVERROR(EAGAIN)) return -13;
        break;
      }
      av_packet_unref(d->pkt);
    }
  }
}

// Consume the next frame; convert to RGB24 into out (H*W*3, tightly
// packed; null = discard). Optionally also emit an antialiased
// (SWS_AREA) downscale into out_low (lh*lw*3). Returns 0 on success,
// 1 on end, <0 on error.
int decoder_read2(JvDecoder* d, uint8_t* out, uint8_t* out_low, int lw,
                  int lh) {
  const int ret = decoder_fetch(d);
  if (ret != 0) return ret;
  d->pending = false;
  if (out != nullptr) {
    if (!d->sws) {
      d->sws = sws_getContext(
          d->frame->width, d->frame->height,
          static_cast<AVPixelFormat>(d->frame->format), d->width, d->height,
          AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr, nullptr);
      if (!d->sws) return -10;
    }
    uint8_t* dst[4] = {out, nullptr, nullptr, nullptr};
    int dst_stride[4] = {3 * d->width, 0, 0, 0};
    sws_scale(d->sws, d->frame->data, d->frame->linesize, 0,
              d->frame->height, dst, dst_stride);
  }
  if (out_low != nullptr) {
    if (!d->sws_low) {
      d->sws_low = sws_getContext(
          d->frame->width, d->frame->height,
          static_cast<AVPixelFormat>(d->frame->format), lw, lh,
          AV_PIX_FMT_RGB24, SWS_AREA, nullptr, nullptr, nullptr);
      if (!d->sws_low) return -14;
    }
    uint8_t* dst[4] = {out_low, nullptr, nullptr, nullptr};
    int dst_stride[4] = {3 * lw, 0, 0, 0};
    sws_scale(d->sws_low, d->frame->data, d->frame->linesize, 0,
              d->frame->height, dst, dst_stride);
  }
  av_frame_unref(d->frame);
  d->next_index++;
  return 0;
}

int decoder_read(JvDecoder* d, uint8_t* out) {
  return decoder_read2(d, out, nullptr, 0, 0);
}

// Position the decoder at frame_start: keyframe seek when the container
// supports it (AVSEEK_FLAG_BACKWARD lands at a keyframe at-or-before the
// target), then decode-and-discard to the exact frame. The landed index
// is derived from the first decoded frame's best_effort_timestamp, which
// stays valid because decoder_fetch leaves the frame pending.
int decoder_seek(JvDecoder* d, int64_t frame_start) {
  if (frame_start <= 0) return 0;
  AVStream* st = d->fmt->streams[d->stream_idx];
  int64_t pos = 0;  // index of the next frame the decoder will produce
  const bool fps_ok =
      st->avg_frame_rate.num > 0 && st->avg_frame_rate.den > 0;
  // frame index <-> timestamp mappings must be offset by the stream's
  // start_time: containers whose first pts is nonzero (MPEG-TS) would
  // otherwise land start_time*fps frames off with no error
  const int64_t t0 =
      st->start_time != AV_NOPTS_VALUE ? st->start_time : 0;
  if (fps_ok) {
    const int64_t ts =
        t0 + av_rescale_q(frame_start, av_inv_q(st->avg_frame_rate),
                          st->time_base);
    if (av_seek_frame(d->fmt, d->stream_idx, ts, AVSEEK_FLAG_BACKWARD) >= 0) {
      avcodec_flush_buffers(d->dec);
      d->drained = false;
      d->pending = false;
      if (decoder_fetch(d) != 0) return -20;
      const int64_t bts = d->frame->best_effort_timestamp;
      int64_t landed = -1;
      if (bts != AV_NOPTS_VALUE) {
        landed = av_rescale_q(bts - t0, st->time_base,
                              av_inv_q(st->avg_frame_rate));
      }
      if (landed >= 0 && landed <= frame_start) {
        pos = landed;  // the pending frame IS frame `landed`
      } else {
        // unknown/overshot landing: rewind to the stream start and skip
        // sequentially (always correct, just slower)
        if (av_seek_frame(d->fmt, d->stream_idx, t0,
                          AVSEEK_FLAG_BACKWARD) < 0) return -21;
        avcodec_flush_buffers(d->dec);
        d->drained = false;
        d->pending = false;
        av_frame_unref(d->frame);
        pos = 0;
      }
    }
  }
  while (pos < frame_start) {
    if (decoder_read(d, nullptr) != 0) return -22;
    ++pos;
  }
  d->next_index = frame_start;
  return 0;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Single-reader C ABI (benchmarks, probing, fallback paths).
// ---------------------------------------------------------------------------
void* jv_open(const char* path, int64_t frame_start) {
  auto* d = new JvDecoder();
  if (decoder_open(d, path) != 0 || decoder_seek(d, frame_start) != 0) {
    decoder_close(d);
    delete d;
    return nullptr;
  }
  return d;
}

void jv_info(void* h, int32_t* width, int32_t* height, int64_t* n_frames) {
  auto* d = static_cast<JvDecoder*>(h);
  *width = d->width;
  *height = d->height;
  *n_frames = d->n_frames;
}

// 0 = frame written, 1 = end of stream, <0 = error.
int jv_read(void* h, uint8_t* out) {
  return decoder_read(static_cast<JvDecoder*>(h), out);
}

void jv_close(void* h) {
  auto* d = static_cast<JvDecoder*>(h);
  decoder_close(d);
  delete d;
}

// Probe (width, height, n_frames) without keeping the file open.
int jv_probe(const char* path, int32_t* width, int32_t* height,
             int64_t* n_frames) {
  JvDecoder d;
  if (decoder_open(&d, path) != 0) {
    decoder_close(&d);
    return -1;
  }
  *width = d.width;
  *height = d.height;
  *n_frames = d.n_frames;
  decoder_close(&d);
  return 0;
}

// ---------------------------------------------------------------------------
// Multi-camera ring pipeline. Python allocates n_buffers ring buffers of
// shape (T, C, H, W, 3); C++ worker threads decode camera groups into them
// frame-interleaved and an emitter publishes complete batches in order.
// Mirrors prediction/video_io.MultiCameraReader's proven ring semantics.
// ---------------------------------------------------------------------------
struct JvPool {
  std::vector<JvDecoder*> decs;
  int32_t T = 0, C = 0, W = 0, H = 0;
  int64_t number_frames = 0;
  std::vector<uint8_t*> buffers;
  std::vector<uint8_t*> low_buffers;  // optional paired downscale ring
  int32_t LW = 0, LH = 0;

  std::mutex mu;
  std::condition_variable cv;        // ring-state changes
  std::vector<int32_t> assigned;     // batch b -> buffer idx (-1 = handed out)
  std::deque<int32_t> free_bufs;
  std::vector<int64_t> progress;     // per camera; negative-encoded when done
  // min frame count of any camera that ended early (guarded by mu). No
  // batch at or beyond it can ever complete, so workers must not claim
  // ring buffers for them: a camera ending more than one ring-capacity
  // before the others would otherwise deadlock the pool (survivors block
  // on buffers the consumer never receives, the emitter waits for the
  // survivors to finish).
  int64_t effective_end = 0;
  bool stopped = false;

  std::queue<std::pair<int32_t, int32_t>> ready;  // (buffer idx, n frames)
  std::condition_variable cv_ready;
  bool exhausted = false;

  std::vector<std::thread> workers;
  std::thread emitter;
};

static int32_t pool_buffer_for(JvPool* p, int64_t b) {
  std::unique_lock<std::mutex> lk(p->mu);
  while (static_cast<int64_t>(p->assigned.size()) <= b) {
    if (p->stopped) return -1;
    if (b * static_cast<int64_t>(p->T) >= p->effective_end) return -1;
    if (!p->free_bufs.empty()) {
      p->assigned.push_back(p->free_bufs.front());
      p->free_bufs.pop_front();
    } else {
      p->cv.wait(lk);
    }
  }
  return p->assigned[b];
}

static void pool_worker(JvPool* p, std::vector<int32_t> cams) {
  const size_t frame_bytes = static_cast<size_t>(p->H) * p->W * 3;
  const size_t cam_stride = frame_bytes;                    // within a slot
  const size_t slot_stride = static_cast<size_t>(p->C) * frame_bytes;
  const bool low = !p->low_buffers.empty();
  const size_t low_frame = static_cast<size_t>(p->LH) * p->LW * 3;
  const size_t low_slot = static_cast<size_t>(p->C) * low_frame;
  std::vector<int32_t> live = cams;
  // Unknown-length streams (number_frames == INT64_MAX): probe EOF with
  // decoder_fetch (decodes into the pending slot, consumed by the later
  // decoder_read2) BEFORE claiming each new batch's ring buffer —
  // otherwise discovering EOF requires acquiring a buffer for a phantom
  // batch, which blocks forever when the consumer holds the whole ring.
  const bool probe_eof = p->number_frames == INT64_MAX;
  for (int64_t f = 0; f < p->number_frames && !live.empty(); ++f) {
    if (probe_eof && f % p->T == 0) {
      for (size_t k = 0; k < live.size();) {
        const int32_t c = live[k];
        if (decoder_fetch(p->decs[c]) != 0) {
          std::lock_guard<std::mutex> lk(p->mu);
          if (p->progress[c] < p->effective_end)
            p->effective_end = p->progress[c];
          p->progress[c] = -p->progress[c] - 1;  // mark done
          live.erase(live.begin() + k);
          p->cv.notify_all();
          continue;
        }
        ++k;
      }
      if (live.empty()) break;
    }
    const int32_t bi = pool_buffer_for(p, f / p->T);
    if (bi < 0) break;
    uint8_t* slot = p->buffers[bi] + (f % p->T) * slot_stride;
    uint8_t* lslot =
        low ? p->low_buffers[bi] + (f % p->T) * low_slot : nullptr;
    for (size_t k = 0; k < live.size();) {
      const int32_t c = live[k];
      if (decoder_read2(p->decs[c], slot + c * cam_stride,
                        low ? lslot + c * low_frame : nullptr, p->LW,
                        p->LH) != 0) {
        std::lock_guard<std::mutex> lk(p->mu);
        if (p->progress[c] < p->effective_end)
          p->effective_end = p->progress[c];
        p->progress[c] = -p->progress[c] - 1;  // mark done
        live.erase(live.begin() + k);
        p->cv.notify_all();
        continue;
      }
      ++k;
    }
    std::lock_guard<std::mutex> lk(p->mu);
    for (int32_t c : live) p->progress[c] = f + 1;
    p->cv.notify_all();
  }
  std::lock_guard<std::mutex> lk(p->mu);
  for (int32_t c : live) p->progress[c] = -p->progress[c] - 1;
  p->cv.notify_all();
}

static void pool_emit(JvPool* p) {
  const int32_t T = p->T;
  int64_t b = 0;
  while (true) {
    const int64_t end = std::min<int64_t>((b + 1) * T, p->number_frames);
    int32_t n = 0, bi = -1;
    bool done = false;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      while (true) {
        int64_t lo = INT64_MAX;
        done = true;
        for (int64_t pr : p->progress) {
          const int64_t v = pr >= 0 ? pr : -pr - 1;
          if (pr >= 0) done = false;
          lo = std::min(lo, v);
        }
        if (p->stopped) return;
        if (lo >= end || done) {
          n = static_cast<int32_t>(std::min(lo, end) - b * T);
          break;
        }
        p->cv.wait(lk);
      }
      if (n > 0) {
        bi = p->assigned[b];
        p->assigned[b] = -1;  // consumer owns it until recycle
      }
      if (n <= 0) {
        p->exhausted = true;
        p->cv_ready.notify_all();
        return;
      }
      p->ready.emplace(bi, n);
      p->cv_ready.notify_all();
      const int64_t lo_after = b * T + n;
      if ((done && lo_after < (b + 1) * T) || end >= p->number_frames) {
        p->exhausted = true;
        p->cv_ready.notify_all();
        return;
      }
    }
    ++b;
  }
}

// buffers: n_buffers pointers, each (T*C*H*W*3) bytes. low_buffers
// (nullable): paired (T*C*low_h*low_w*3) downscale ring filled from the
// same decoded frames (one extra SWS_AREA pass, no second decode).
// Returns null on any open/seek failure or resolution mismatch.
void* jv_pool_create2(const char** paths, int32_t n_cams, int64_t frame_start,
                      int64_t number_frames, int32_t T, uint8_t** buffers,
                      int32_t n_buffers, int32_t n_threads,
                      uint8_t** low_buffers, int32_t low_w, int32_t low_h) {
  auto* p = new JvPool();
  p->T = T;
  p->C = n_cams;
  for (int32_t c = 0; c < n_cams; ++c) {
    auto* d = new JvDecoder();
    if (decoder_open(d, paths[c]) != 0 ||
        decoder_seek(d, frame_start) != 0) {
      decoder_close(d);
      delete d;
      for (auto* dd : p->decs) {
        decoder_close(dd);
        delete dd;
      }
      delete p;
      return nullptr;
    }
    if (c == 0) {
      p->W = d->width;
      p->H = d->height;
    } else if (d->width != p->W || d->height != p->H) {
      decoder_close(d);
      delete d;
      for (auto* dd : p->decs) {
        decoder_close(dd);
        delete dd;
      }
      delete p;
      return nullptr;
    }
    p->decs.push_back(d);
  }
  int64_t total = p->decs[0]->n_frames;
  if (number_frames >= 0) {
    p->number_frames = number_frames;
  } else if (total > 0) {
    p->number_frames = total - frame_start;
  } else {
    // container reports no frame count (nb_frames=0 and no duration,
    // e.g. some MKV/raw streams): decode until EOF — the worker loop
    // exits on stream exhaustion and the emitter flags the partial
    // final batch, so an unbounded limit terminates correctly
    p->number_frames = INT64_MAX;
  }
  for (int32_t i = 0; i < n_buffers; ++i) {
    p->buffers.push_back(buffers[i]);
    p->free_bufs.push_back(i);
  }
  if (low_buffers != nullptr) {
    for (int32_t i = 0; i < n_buffers; ++i)
      p->low_buffers.push_back(low_buffers[i]);
    p->LW = low_w;
    p->LH = low_h;
  }
  p->progress.assign(n_cams, 0);
  p->effective_end = p->number_frames;

  if (n_threads < 1) n_threads = 1;
  const int32_t K = std::min(n_threads, n_cams);
  for (int32_t w = 0; w < K; ++w) {
    std::vector<int32_t> cams;
    for (int32_t c = w; c < n_cams; c += K) cams.push_back(c);
    p->workers.emplace_back(pool_worker, p, std::move(cams));
  }
  p->emitter = std::thread(pool_emit, p);
  return p;
}

void* jv_pool_create(const char** paths, int32_t n_cams, int64_t frame_start,
                     int64_t number_frames, int32_t T, uint8_t** buffers,
                     int32_t n_buffers, int32_t n_threads) {
  return jv_pool_create2(paths, n_cams, frame_start, number_frames, T,
                         buffers, n_buffers, n_threads, nullptr, 0, 0);
}

void jv_pool_info(void* h, int32_t* width, int32_t* height,
                  int64_t* number_frames) {
  auto* p = static_cast<JvPool*>(h);
  *width = p->W;
  *height = p->H;
  *number_frames = p->number_frames;
}

// Blocks for the next complete batch. Returns the buffer index and writes
// the valid-frame count to *n; returns -1 when the stream is exhausted.
int32_t jv_pool_next(void* h, int32_t* n) {
  auto* p = static_cast<JvPool*>(h);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [p]() {
    return !p->ready.empty() || p->exhausted || p->stopped;
  });
  if (p->ready.empty()) return -1;
  auto item = p->ready.front();
  p->ready.pop();
  *n = item.second;
  return item.first;
}

void jv_pool_recycle(void* h, int32_t buffer_idx) {
  auto* p = static_cast<JvPool*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  p->free_bufs.push_back(buffer_idx);
  p->cv.notify_all();
}

void jv_pool_destroy(void* h) {
  auto* p = static_cast<JvPool*>(h);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stopped = true;
    p->cv.notify_all();
    p->cv_ready.notify_all();
  }
  for (auto& t : p->workers)
    if (t.joinable()) t.join();
  if (p->emitter.joinable()) p->emitter.join();
  for (auto* d : p->decs) {
    decoder_close(d);
    delete d;
  }
  delete p;
}

}  // extern "C"
