// Native audio decoder over the system ffmpeg libraries.
//
// Replaces the libsndfile-backed fairseq2n AudioDecoder capability used by
// the reference speech pipelines (sonar/inference_pipelines/speech.py:23,296)
// with libavformat/libavcodec/libswresample: decodes any container/codec the
// system ffmpeg supports (flac, ogg/vorbis, opus, mp3, wav, ...) from an
// in-memory buffer to interleaved float32 at the stream's native sample rate
// and channel count. Exposed through a minimal C ABI consumed via ctypes
// (sonar_tpu_torch/native/__init__.py); the RIFF/WAV fast path stays in Python.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

namespace {

struct MemReader {
  const uint8_t* data;
  int64_t size;
  int64_t pos;
};

int mem_read(void* opaque, uint8_t* buf, int buf_size) {
  MemReader* r = static_cast<MemReader*>(opaque);
  int64_t left = r->size - r->pos;
  if (left <= 0) return AVERROR_EOF;
  int n = static_cast<int>(left < buf_size ? left : buf_size);
  std::memcpy(buf, r->data + r->pos, n);
  r->pos += n;
  return n;
}

int64_t mem_seek(void* opaque, int64_t offset, int whence) {
  MemReader* r = static_cast<MemReader*>(opaque);
  if (whence == AVSEEK_SIZE) return r->size;
  int64_t target;
  switch (whence & ~AVSEEK_FORCE) {
    case SEEK_SET: target = offset; break;
    case SEEK_CUR: target = r->pos + offset; break;
    case SEEK_END: target = r->size + offset; break;
    default: return AVERROR(EINVAL);
  }
  if (target < 0 || target > r->size) return AVERROR(EINVAL);
  r->pos = target;
  return target;
}

struct DecodeState {
  AVFormatContext* fmt = nullptr;
  AVIOContext* avio = nullptr;
  AVCodecContext* codec = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;

  ~DecodeState() {
    if (pkt) av_packet_free(&pkt);
    if (frame) av_frame_free(&frame);
    if (swr) swr_free(&swr);
    if (codec) avcodec_free_context(&codec);
    if (fmt) avformat_close_input(&fmt);
    if (avio) {
      av_freep(&avio->buffer);
      avio_context_free(&avio);
    }
  }
};

// Convert one decoded frame to interleaved float32 and append to out.
int append_frame(DecodeState& s, const AVFrame* f, int channels,
                 std::vector<float>& out) {
  int max_out = f->nb_samples + 256;
  size_t base = out.size();
  out.resize(base + static_cast<size_t>(max_out) * channels);
  uint8_t* dst = reinterpret_cast<uint8_t*>(out.data() + base);
  int got = swr_convert(s.swr, &dst, max_out,
                        const_cast<const uint8_t**>(f->extended_data),
                        f->nb_samples);
  if (got < 0) return got;
  out.resize(base + static_cast<size_t>(got) * channels);
  return 0;
}

}  // namespace

extern "C" {

// Decode an in-memory audio blob.
// On success returns 0 and fills *out (malloc'd interleaved float32,
// release with sonar_audio_free), *n_frames, *sample_rate, *channels.
// Returns a negative AVERROR-style code on failure.
int sonar_audio_decode(const uint8_t* data, int64_t size, float** out,
                       int64_t* n_frames, int* sample_rate, int* channels) {
  DecodeState s;
  MemReader reader{data, size, 0};

  constexpr int kIoBuf = 1 << 16;
  uint8_t* io_buf = static_cast<uint8_t*>(av_malloc(kIoBuf));
  if (!io_buf) return AVERROR(ENOMEM);
  s.avio = avio_alloc_context(io_buf, kIoBuf, 0, &reader, mem_read, nullptr,
                              mem_seek);
  if (!s.avio) {
    av_free(io_buf);
    return AVERROR(ENOMEM);
  }
  s.fmt = avformat_alloc_context();
  if (!s.fmt) return AVERROR(ENOMEM);
  s.fmt->pb = s.avio;
  int rc = avformat_open_input(&s.fmt, nullptr, nullptr, nullptr);
  if (rc < 0) return rc;
  rc = avformat_find_stream_info(s.fmt, nullptr);
  if (rc < 0) return rc;

  const AVCodec* decoder = nullptr;
  int stream_idx =
      av_find_best_stream(s.fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &decoder, 0);
  if (stream_idx < 0) return stream_idx;
  AVStream* stream = s.fmt->streams[stream_idx];

  s.codec = avcodec_alloc_context3(decoder);
  if (!s.codec) return AVERROR(ENOMEM);
  rc = avcodec_parameters_to_context(s.codec, stream->codecpar);
  if (rc < 0) return rc;
  rc = avcodec_open2(s.codec, decoder, nullptr);
  if (rc < 0) return rc;

  int ch = s.codec->ch_layout.nb_channels;
  if (ch <= 0) return AVERROR(EINVAL);
  AVChannelLayout out_layout;
  av_channel_layout_default(&out_layout, ch);
  rc = swr_alloc_set_opts2(&s.swr, &out_layout, AV_SAMPLE_FMT_FLT,
                           s.codec->sample_rate, &s.codec->ch_layout,
                           s.codec->sample_fmt, s.codec->sample_rate, 0,
                           nullptr);
  if (rc < 0) return rc;
  rc = swr_init(s.swr);
  if (rc < 0) return rc;

  s.pkt = av_packet_alloc();
  s.frame = av_frame_alloc();
  if (!s.pkt || !s.frame) return AVERROR(ENOMEM);

  std::vector<float> samples;
  while ((rc = av_read_frame(s.fmt, s.pkt)) >= 0) {
    if (s.pkt->stream_index == stream_idx) {
      rc = avcodec_send_packet(s.codec, s.pkt);
      if (rc < 0 && rc != AVERROR(EAGAIN)) {
        av_packet_unref(s.pkt);
        return rc;
      }
      while ((rc = avcodec_receive_frame(s.codec, s.frame)) >= 0) {
        rc = append_frame(s, s.frame, ch, samples);
        if (rc < 0) {
          av_packet_unref(s.pkt);
          return rc;
        }
      }
      if (rc != AVERROR(EAGAIN) && rc != AVERROR_EOF) {
        av_packet_unref(s.pkt);
        return rc;
      }
    }
    av_packet_unref(s.pkt);
  }
  if (rc != AVERROR_EOF) return rc;

  // Flush the decoder and the resampler.
  avcodec_send_packet(s.codec, nullptr);
  while (avcodec_receive_frame(s.codec, s.frame) >= 0) {
    rc = append_frame(s, s.frame, ch, samples);
    if (rc < 0) return rc;
  }
  {
    int max_out = 4096;
    size_t base = samples.size();
    samples.resize(base + static_cast<size_t>(max_out) * ch);
    uint8_t* dst = reinterpret_cast<uint8_t*>(samples.data() + base);
    int got = swr_convert(s.swr, &dst, max_out, nullptr, 0);
    samples.resize(base + static_cast<size_t>(got > 0 ? got : 0) * ch);
  }

  if (samples.empty()) return AVERROR_INVALIDDATA;

  float* buf = static_cast<float*>(malloc(samples.size() * sizeof(float)));
  if (!buf) return AVERROR(ENOMEM);
  std::memcpy(buf, samples.data(), samples.size() * sizeof(float));
  *out = buf;
  *n_frames = static_cast<int64_t>(samples.size() / ch);
  *sample_rate = s.codec->sample_rate;
  *channels = ch;
  return 0;
}

void sonar_audio_free(float* buf) { free(buf); }

}  // extern "C"
