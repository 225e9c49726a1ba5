// Native audio decode for the GEM dataset's with_audio path.
//
// Decodes the first audio stream of an MP4/MOV over a [start, end] pts
// window with the reference's stream-read semantics (reference
// routeformer/io/dataset.py:2280-2369, torchvision's _read_from_stream):
//   - window bounds in stream time_base: [floor(start/tb), ceil(end/tb)]
//   - a frame belongs to the window iff start_pts <= frame.pts <= end_pts
//   - if no frame lands exactly on start_pts, the last frame preceding it
//     is prepended (audio packets rarely align with the requested start)
//   - sample values keep their native scale (AAC fltp in [-1, 1]; PCM s16
//     as raw integer values cast to float), matching the reference's
//     np.concatenate(..., dtype=np.float32) of PyAV frame.to_ndarray().
//
// The port's copy of the JAX package's native/audio.cpp. Built against the
// system ffmpeg libraries by routeformer_torch/io/native.py at first use
// (g++ -O3 -std=c++17 -shared -fPIC -lavformat -lavcodec -lavutil). ctypes
// ABI: see routeformer_torch/io/audio.py for the Python side and the
// pure-Python PCM twin.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
}

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// One decoded frame's samples, interleaved float32.
struct Chunk {
  int64_t pts;
  int64_t n;  // samples per channel
  std::vector<float> data;  // n * channels, interleaved
};

float sample_to_float(const AVFrame* f, int ch, int64_t i) {
  const auto fmt = static_cast<AVSampleFormat>(f->format);
  const bool planar = av_sample_fmt_is_planar(fmt) != 0;
  const int nb_ch = f->ch_layout.nb_channels;
  const uint8_t* plane = planar ? f->extended_data[ch] : f->extended_data[0];
  const int64_t idx = planar ? i : i * nb_ch + ch;
  switch (av_get_packed_sample_fmt(fmt)) {
    case AV_SAMPLE_FMT_FLT:
      return reinterpret_cast<const float*>(plane)[idx];
    case AV_SAMPLE_FMT_DBL:
      return static_cast<float>(reinterpret_cast<const double*>(plane)[idx]);
    case AV_SAMPLE_FMT_S16:
      return static_cast<float>(reinterpret_cast<const int16_t*>(plane)[idx]);
    case AV_SAMPLE_FMT_S32:
      return static_cast<float>(reinterpret_cast<const int32_t*>(plane)[idx]);
    case AV_SAMPLE_FMT_U8:
      return static_cast<float>(
          static_cast<int>(plane[idx]) - 128);
    default:
      return 0.0f;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success; negative error codes otherwise:
//  -1 open failed, -2 no audio stream, -3 decoder missing/failed,
//  -4 seek failed, -5 no frames in window.
// *out is malloc'd interleaved float32 (n_samples x n_channels); free with
// rf_audio_free.
int rf_audio_decode(const char* path, double start_sec, double end_sec,
                    float** out, long long* out_samples, int* out_channels,
                    int* out_rate) {
  *out = nullptr;
  *out_samples = 0;
  *out_channels = 0;
  *out_rate = 0;

  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -1;
  }
  int stream_idx =
      av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
  if (stream_idx < 0) {
    avformat_close_input(&fmt);
    return -2;
  }
  AVStream* st = fmt->streams[stream_idx];
  const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
  if (!codec) {
    avformat_close_input(&fmt);
    return -3;
  }
  AVCodecContext* ctx = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(ctx, st->codecpar);
  if (avcodec_open2(ctx, codec, nullptr) < 0) {
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    return -3;
  }

  const double tb = av_q2d(st->time_base);
  const int64_t start_pts =
      static_cast<int64_t>(std::floor(start_sec / tb));
  const int64_t end_pts =
      std::isinf(end_sec) ? INT64_MAX
                          : static_cast<int64_t>(std::ceil(end_sec / tb));
  // reference seek slack: "some files don't seek to the right location"
  const int64_t seek_pts = start_pts > 1 ? start_pts - 1 : 0;
  if (av_seek_frame(fmt, stream_idx, seek_pts, AVSEEK_FLAG_BACKWARD) < 0) {
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    return -4;
  }

  std::vector<Chunk> window;       // frames with pts in [start, end]
  Chunk preceding;                 // last frame with pts < start
  bool have_preceding = false, have_exact_start = false;

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  bool done = false;
  int channels = 0;
  // One window classification for both the read loop and the decoder
  // drain: AAC has decoder delay, so the trailing frame(s) of a window
  // that reaches the file's end only surface after the NULL flush packet
  // and must go through the same pts-window logic as streamed frames.
  auto classify = [&](AVFrame* f) {
    const int64_t pts = f->pts != AV_NOPTS_VALUE ? f->pts : f->pkt_dts;
    channels = f->ch_layout.nb_channels;
    Chunk c;
    c.pts = pts;
    c.n = f->nb_samples;
    c.data.resize(static_cast<size_t>(c.n) * channels);
    for (int64_t i = 0; i < c.n; ++i)
      for (int ch = 0; ch < channels; ++ch)
        c.data[static_cast<size_t>(i) * channels + ch] =
            sample_to_float(f, ch, i);
    if (pts < start_pts) {
      preceding = std::move(c);
      have_preceding = true;
    } else if (pts <= end_pts) {
      if (pts == start_pts) have_exact_start = true;
      window.push_back(std::move(c));
      if (pts >= end_pts) done = true;
    } else {
      done = true;
    }
  };
  while (!done && av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == stream_idx &&
        avcodec_send_packet(ctx, pkt) >= 0) {
      while (avcodec_receive_frame(ctx, frame) >= 0) {
        classify(frame);
        av_frame_unref(frame);
      }
    }
    av_packet_unref(pkt);
  }
  // drain buffered frames through the same window classification
  avcodec_send_packet(ctx, nullptr);
  while (!done && avcodec_receive_frame(ctx, frame) >= 0) {
    classify(frame);
    av_frame_unref(frame);
  }
  av_frame_free(&frame);
  av_packet_free(&pkt);
  avcodec_free_context(&ctx);
  const int rate = st->codecpar->sample_rate;
  avformat_close_input(&fmt);

  if (have_preceding && start_pts > 0 && !have_exact_start)
    window.insert(window.begin(), std::move(preceding));
  if (window.empty() || channels == 0) return -5;

  int64_t total = 0;
  for (const auto& c : window) total += c.n;
  float* buf = static_cast<float*>(
      std::malloc(static_cast<size_t>(total) * channels * sizeof(float)));
  if (!buf) return -5;
  float* p = buf;
  for (const auto& c : window) {
    std::memcpy(p, c.data.data(), c.data.size() * sizeof(float));
    p += c.data.size();
  }
  *out = buf;
  *out_samples = total;
  *out_channels = channels;
  *out_rate = rate;
  return 0;
}

void rf_audio_free(float* p) { std::free(p); }

// Fixture helper: encode mono float32 samples as an AAC track in an MP4.
// Real GoPro/Pupil recordings carry AAC; no encoder exists elsewhere in
// this image (cv2 h264/aac encode is disabled), so tests use this to build
// byte-real compressed-audio fixtures and assert the decoder's
// window/prepend/drain semantics on them (self-consistency against a
// full-file decode — see tests/test_audio.py).
// Returns 0 on success; negative codes on failure.
int rf_audio_encode_aac(const char* path, const float* samples,
                        long long n_samples, int rate) {
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, "mp4", path) < 0 || !fmt)
    return -1;
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_AAC);
  if (!codec) {
    avformat_free_context(fmt);
    return -2;
  }
  AVCodecContext* ctx = avcodec_alloc_context3(codec);
  ctx->sample_rate = rate;
  ctx->sample_fmt = AV_SAMPLE_FMT_FLTP;
  av_channel_layout_default(&ctx->ch_layout, 1);
  ctx->time_base = AVRational{1, rate};
  ctx->bit_rate = 128000;
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(ctx, codec, nullptr) < 0) {
    avcodec_free_context(&ctx);
    avformat_free_context(fmt);
    return -3;
  }
  AVStream* st = avformat_new_stream(fmt, nullptr);
  avcodec_parameters_from_context(st->codecpar, ctx);
  st->time_base = ctx->time_base;
  if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
    avcodec_free_context(&ctx);
    avformat_free_context(fmt);
    return -4;
  }
  if (avformat_write_header(fmt, nullptr) < 0) {
    avcodec_free_context(&ctx);
    avformat_free_context(fmt);
    return -5;
  }

  AVPacket* pkt = av_packet_alloc();
  auto mux = [&]() -> bool {
    while (true) {
      int rc = avcodec_receive_packet(ctx, pkt);
      if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return true;
      if (rc < 0) return false;
      av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
      pkt->stream_index = st->index;
      if (av_interleaved_write_frame(fmt, pkt) < 0) return false;
    }
  };

  const int frame_n = ctx->frame_size > 0 ? ctx->frame_size : 1024;
  AVFrame* frame = av_frame_alloc();
  bool ok = true;
  long long pos = 0;
  while (ok && pos < n_samples) {
    const int n = static_cast<int>(
        n_samples - pos < frame_n ? n_samples - pos : frame_n);
    frame->nb_samples = n;
    frame->format = AV_SAMPLE_FMT_FLTP;
    av_channel_layout_default(&frame->ch_layout, 1);
    frame->sample_rate = rate;
    frame->pts = pos;
    if (av_frame_get_buffer(frame, 0) < 0) {
      ok = false;
      break;
    }
    std::memcpy(frame->extended_data[0], samples + pos,
                static_cast<size_t>(n) * sizeof(float));
    ok = avcodec_send_frame(ctx, frame) >= 0 && mux();
    av_frame_unref(frame);
    pos += n;
  }
  if (ok) ok = avcodec_send_frame(ctx, nullptr) >= 0 && mux();
  if (ok) ok = av_write_trailer(fmt) >= 0;

  av_frame_free(&frame);
  av_packet_free(&pkt);
  avcodec_free_context(&ctx);
  if (!(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return ok ? 0 : -6;
}

}  // extern "C"
