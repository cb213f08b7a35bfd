// beamio: native audio-runtime library for beamform_tpu.
//
// The compute path is JAX/XLA; this library is the native runtime
// around it, covering what the reference implements in C++ inside rosjack
// (beamform/src/rosjack/rosjack.cpp): WAV file I/O with libsndfile-equivalent
// float->PCM conversion, a lock-free single-producer/single-consumer ring
// buffer (the jack_ringbuffer role), a streaming polyphase sinc sample-rate
// converter (the libsamplerate role), and chunked WAV streaming for
// feeding fixed-size hops to the compute engine without loading whole
// files.
//
// C ABI throughout (consumed from Python via ctypes).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// WAV container
// ---------------------------------------------------------------------------

#pragma pack(push, 1)
struct FmtChunk {
  uint16_t tag;
  uint16_t channels;
  uint32_t sample_rate;
  uint32_t byte_rate;
  uint16_t block_align;
  uint16_t bits;
};
#pragma pack(pop)

struct WavInfo {
  uint16_t tag = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_offset = 0;
  long data_bytes = 0;
};

bool read_header(FILE* f, WavInfo* info) {
  char id[4];
  uint32_t size;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "RIFF", 4)) return false;
  if (fread(&size, 4, 1, f) != 1) return false;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "WAVE", 4)) return false;
  bool have_fmt = false, have_data = false;
  while (!have_data) {
    if (fread(id, 1, 4, f) != 4 || fread(&size, 4, 1, f) != 1) break;
    if (!memcmp(id, "fmt ", 4)) {
      FmtChunk fmt;
      long pos = ftell(f);
      if (fread(&fmt, sizeof(fmt), 1, f) != 1) return false;
      info->tag = fmt.tag;
      info->channels = fmt.channels;
      info->sample_rate = fmt.sample_rate;
      info->bits = fmt.bits;
      if (fmt.tag == 0xFFFE && size >= 26) {
        // WAVE_FORMAT_EXTENSIBLE: real tag at byte 24 of the chunk
        fseek(f, pos + 24, SEEK_SET);
        uint16_t sub;
        if (fread(&sub, 2, 1, f) == 1) info->tag = sub;
      }
      fseek(f, pos + size + (size & 1), SEEK_SET);
      have_fmt = true;
    } else if (!memcmp(id, "data", 4)) {
      info->data_offset = ftell(f);
      info->data_bytes = size;
      have_data = true;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  return have_fmt && have_data;
}

long frame_count(const WavInfo& w) {
  int bytes = w.bits / 8;
  if (!bytes || !w.channels) return 0;
  return w.data_bytes / (bytes * w.channels);
}

// decode `n` interleaved frames starting at the current file position
bool decode_frames(FILE* f, const WavInfo& w, float* out, long n) {
  const long vals = n * w.channels;
  if (w.tag == 1 && w.bits == 16) {
    std::vector<int16_t> buf(vals);
    if (fread(buf.data(), 2, vals, f) != (size_t)vals) return false;
    for (long i = 0; i < vals; ++i) out[i] = buf[i] / 32768.0f;
  } else if (w.tag == 1 && w.bits == 24) {
    std::vector<uint8_t> buf(vals * 3);
    if (fread(buf.data(), 1, vals * 3, f) != (size_t)(vals * 3))
      return false;
    for (long i = 0; i < vals; ++i) {
      int32_t v = buf[3 * i] | (buf[3 * i + 1] << 8) | (buf[3 * i + 2] << 16);
      if (v & 0x800000) v -= 0x1000000;
      out[i] = v / 8388608.0f;
    }
  } else if (w.tag == 1 && w.bits == 32) {
    std::vector<int32_t> buf(vals);
    if (fread(buf.data(), 4, vals, f) != (size_t)vals) return false;
    for (long i = 0; i < vals; ++i) out[i] = (float)(buf[i] / 2147483648.0);
  } else if (w.tag == 3 && w.bits == 32) {
    if (fread(out, 4, vals, f) != (size_t)vals) return false;
  } else if (w.tag == 3 && w.bits == 64) {
    std::vector<double> buf(vals);
    if (fread(buf.data(), 8, vals, f) != (size_t)vals) return false;
    for (long i = 0; i < vals; ++i) out[i] = (float)buf[i];
  } else {
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

// --------------------------- WAV: whole-file ------------------------------

int bio_wav_info(const char* path, int* channels, int* sample_rate,
                 long* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo w;
  bool ok = read_header(f, &w);
  fclose(f);
  if (!ok) return -2;
  *channels = w.channels;
  *sample_rate = (int)w.sample_rate;
  *frames = frame_count(w);
  return 0;
}

// out: caller-allocated frames*channels float32, interleaved
int bio_wav_read(const char* path, float* out, long frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo w;
  if (!read_header(f, &w)) { fclose(f); return -2; }
  fseek(f, w.data_offset, SEEK_SET);
  long n = frame_count(w);
  if (frames < n) n = frames;
  bool ok = decode_frames(f, w, out, n);
  fclose(f);
  return ok ? 0 : -3;
}

// fmt: 0=pcm16 1=pcm24 2=pcm32 3=float32. PCM16 matches libsndfile's
// sf_write_float on a PCM_16 file without clipping: lrint(x*32768), wraps
// on overflow (rosjack.cpp:197,404-409).
int bio_wav_write(const char* path, const float* interleaved, long frames,
                  int channels, int sample_rate, int fmt) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const long vals = frames * channels;
  uint16_t tag = (fmt == 3) ? 3 : 1;
  uint16_t bits = (fmt == 0) ? 16 : (fmt == 1) ? 24 : 32;
  uint32_t payload = (uint32_t)(vals * (bits / 8));
  FmtChunk fc{tag, (uint16_t)channels, (uint32_t)sample_rate,
              (uint32_t)(sample_rate * channels * (bits / 8)),
              (uint16_t)(channels * (bits / 8)), bits};
  uint32_t riff = 4 + 8 + sizeof(fc) + 8 + payload;
  fwrite("RIFF", 1, 4, f);
  fwrite(&riff, 4, 1, f);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  uint32_t fsz = sizeof(fc);
  fwrite(&fsz, 4, 1, f);
  fwrite(&fc, sizeof(fc), 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&payload, 4, 1, f);
  if (fmt == 0) {
    std::vector<int16_t> buf(vals);
    for (long i = 0; i < vals; ++i)
      buf[i] = (int16_t)(int64_t)llrintf(interleaved[i] * 32768.0f);
    fwrite(buf.data(), 2, vals, f);
  } else if (fmt == 1) {
    std::vector<uint8_t> buf(vals * 3);
    for (long i = 0; i < vals; ++i) {
      int32_t v = (int32_t)(int64_t)llrintf(interleaved[i] * 8388608.0f);
      buf[3 * i] = v & 0xFF;
      buf[3 * i + 1] = (v >> 8) & 0xFF;
      buf[3 * i + 2] = (v >> 16) & 0xFF;
    }
    fwrite(buf.data(), 1, vals * 3, f);
  } else if (fmt == 2) {
    std::vector<int32_t> buf(vals);
    for (long i = 0; i < vals; ++i) {
      double q = llrint(interleaved[i] * 2147483648.0);
      if (q > 2147483647.0) q = 2147483647.0;
      if (q < -2147483648.0) q = -2147483648.0;
      buf[i] = (int32_t)q;
    }
    fwrite(buf.data(), 4, vals, f);
  } else {
    fwrite(interleaved, 4, vals, f);
  }
  fclose(f);
  return 0;
}

// --------------------------- WAV: streaming -------------------------------

struct BioWavStream {
  FILE* f;
  WavInfo w;
  long frames_left;
};

void* bio_wav_stream_open(const char* path, int* channels, int* sample_rate,
                          long* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  WavInfo w;
  if (!read_header(f, &w)) { fclose(f); return nullptr; }
  fseek(f, w.data_offset, SEEK_SET);
  auto* s = new BioWavStream{f, w, frame_count(w)};
  *channels = w.channels;
  *sample_rate = (int)w.sample_rate;
  *frames = s->frames_left;
  return s;
}

// returns frames actually read (zero-padded to `frames` at EOF)
long bio_wav_stream_read(void* handle, float* out, long frames) {
  auto* s = (BioWavStream*)handle;
  long n = frames < s->frames_left ? frames : s->frames_left;
  if (n > 0 && !decode_frames(s->f, s->w, out, n)) return -1;
  long pad = (frames - n) * s->w.channels;
  if (pad > 0) memset(out + n * s->w.channels, 0, pad * sizeof(float));
  s->frames_left -= n;
  return n;
}

void bio_wav_stream_close(void* handle) {
  auto* s = (BioWavStream*)handle;
  fclose(s->f);
  delete s;
}

// ------------------- lock-free SPSC ring buffer ----------------------------
// The jack_ringbuffer role (util.h:265-287): one real-time producer, one
// consumer, no locks — acquire/release atomics on the read/write indices.

struct BioRing {
  std::vector<float> buf;
  size_t cap;  // power of two
  std::atomic<size_t> w{0}, r{0};
};

void* bio_ring_create(long capacity) {
  size_t cap = 1;
  while (cap < (size_t)capacity) cap <<= 1;
  auto* rb = new BioRing;
  rb->buf.resize(cap);
  rb->cap = cap;
  return rb;
}

long bio_ring_write(void* h, const float* data, long n) {
  auto* rb = (BioRing*)h;
  size_t w = rb->w.load(std::memory_order_relaxed);
  size_t r = rb->r.load(std::memory_order_acquire);
  size_t free_space = rb->cap - (w - r);
  size_t todo = (size_t)n < free_space ? (size_t)n : free_space;
  for (size_t i = 0; i < todo; ++i) rb->buf[(w + i) & (rb->cap - 1)] = data[i];
  rb->w.store(w + todo, std::memory_order_release);
  return (long)todo;
}

long bio_ring_read(void* h, float* out, long n) {
  auto* rb = (BioRing*)h;
  size_t r = rb->r.load(std::memory_order_relaxed);
  size_t w = rb->w.load(std::memory_order_acquire);
  size_t avail = w - r;
  size_t todo = (size_t)n < avail ? (size_t)n : avail;
  for (size_t i = 0; i < todo; ++i) out[i] = rb->buf[(r + i) & (rb->cap - 1)];
  rb->r.store(r + todo, std::memory_order_release);
  return (long)todo;
}

long bio_ring_available(void* h) {
  auto* rb = (BioRing*)h;
  return (long)(rb->w.load(std::memory_order_acquire)
                - rb->r.load(std::memory_order_acquire));
}

void bio_ring_free(void* h) { delete (BioRing*)h; }

// -------------------- streaming polyphase resampler ------------------------
// The libsamplerate role (rosjack.cpp:159-187, 311-350): windowed-sinc
// polyphase conversion with streaming state (tail carried across calls).

namespace {
double bessel_i0(double x) {
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}
}  // namespace

struct BioSrc {
  int up, down;
  int taps;             // total filter taps
  int tmax;             // max input samples under the filter support
  std::vector<float> h; // filter
  std::vector<float> tail;  // carried input history
  long u_next = 0;          // next output's upsampled index, relative to
                            // tail[0]'s upsampled position
};

void* bio_src_new(int fs_in, int fs_out, int taps_per_phase) {
  int g = 1;
  for (int d = 1; d <= fs_in && d <= fs_out; ++d)
    if (fs_in % d == 0 && fs_out % d == 0) g = d;
  int up = fs_out / g, down = fs_in / g;
  int longer = up > down ? up : down;
  int taps = 2 * taps_per_phase * longer + 1;
  auto* s = new BioSrc;
  s->up = up;
  s->down = down;
  s->taps = taps;
  s->h.resize(taps);
  const double beta = 9.0;
  const double cutoff = 1.0 / longer;  // fraction of upsampled Nyquist
  const double i0b = bessel_i0(beta);
  const int mid = (taps - 1) / 2;
  for (int i = 0; i < taps; ++i) {
    double t = i - mid;
    double sinc = t == 0 ? cutoff : sin(M_PI * cutoff * t) / (M_PI * t);
    double w = i0b == 0 ? 1.0
        : bessel_i0(beta * sqrt(1.0 - (t / mid) * (t / mid))) / i0b;
    s->h[i] = (float)(sinc * w * up);
  }
  s->tmax = (taps - 1) / up + 1;
  // prime with tmax zeros of history so the first outputs have full
  // filter support (the filter's group delay shifts the output by
  // ~(taps-1)/(2*up) input samples, like any streaming sinc SRC)
  s->tail.assign(s->tmax, 0.0f);
  s->u_next = (long)s->tmax * up;
  return s;
}

// Push n_in input samples; writes up to max_out output samples.
// Returns the number of output samples produced.
//
// Model: xu = zero-stuffed input (xu[i*up] = x[i]); y_u = h * xu;
// output k = y_u[u_next + k*down]. For upsampled index u only taps
// j == u (mod up) contribute: j = j0 + t*up, input index base - t with
// j0 = u % up, base = (u - j0)/up.
long bio_src_process(void* handle, const float* in, long n_in, float* out,
                     long max_out) {
  auto* s = (BioSrc*)handle;
  const int up = s->up, down = s->down, taps = s->taps;
  const long hist = (long)s->tail.size();
  const long len = hist + n_in;
  std::vector<float> x(len);
  memcpy(x.data(), s->tail.data(), hist * sizeof(float));
  if (n_in > 0) memcpy(x.data() + hist, in, n_in * sizeof(float));

  long produced = 0;
  long u = s->u_next;
  while (produced < max_out) {
    int j0 = (int)(u % up);
    long base = (u - j0) / up;       // newest input sample needed
    if (base > len - 1) break;       // not yet available
    int tcnt = (taps - 1 - j0) / up + 1;
    double acc = 0.0;
    long lo = base - tcnt + 1;
    if (lo < 0) { u += down; continue; }  // insufficient history (startup)
    for (int t = 0; t < tcnt; ++t)
      acc += (double)s->h[j0 + t * up] * (double)x[base - t];
    out[produced++] = (float)acc;
    u += down;
  }
  // drop history no future output can need; rebase indices
  long base_next = u / up;
  long drop = base_next - s->tmax + 1;
  if (drop < 0) drop = 0;
  if (drop > len) drop = len;
  s->tail.assign(x.begin() + drop, x.end());
  s->u_next = u - drop * up;
  return produced;
}

void bio_src_free(void* h) { delete (BioSrc*)h; }

}  // extern "C"

// ----------------------- ALSA capture / playback ---------------------------
// The in-process audio-device role of the reference's JACK client
// (rosjack.cpp:102-157 creates the client + ports and registers the
// real-time callback; :234-270 auto-connects the capture/playback ports).
// There is no JACK or ALSA development environment in this image, so the
// backend binds libasound AT RUNTIME via dlopen with a hand-declared ABI:
// the library builds and loads everywhere, bio_alsa_runtime_available()
// reports whether a sound stack actually exists, and open fails with a
// readable error string when it doesn't — the degrade-gracefully contract.
//
// Format policy mirrors the pipe mode (and JACK's native sample type):
// interleaved float32 at the engine rate. Overruns/underruns are recovered
// in place with snd_pcm_recover and COUNTED, exactly the reference's xrun
// accounting (rosjack.cpp:78-82 jack_xrun_callback).

#include <dlfcn.h>

namespace {

// libasound ABI subset (alsa/pcm.h): enum values are part of the stable ABI.
constexpr int kSndPcmStreamPlayback = 0;
constexpr int kSndPcmStreamCapture = 1;
constexpr int kSndPcmFormatFloatLE = 14;
constexpr int kSndPcmAccessRwInterleaved = 3;

struct AlsaApi {
  void* dl = nullptr;
  int (*pcm_open)(void**, const char*, int, int) = nullptr;
  int (*set_params)(void*, int, int, unsigned, unsigned, int, unsigned)
      = nullptr;
  long (*readi)(void*, void*, unsigned long) = nullptr;
  long (*writei)(void*, const void*, unsigned long) = nullptr;
  int (*recover)(void*, int, int) = nullptr;
  int (*prepare)(void*) = nullptr;
  int (*drain)(void*) = nullptr;
  int (*close)(void*) = nullptr;
  const char* (*strerror_)(int) = nullptr;
};

AlsaApi* alsa_api() {
  static AlsaApi api;
  static bool tried = false;
  if (tried) return api.dl ? &api : nullptr;
  tried = true;
  void* dl = dlopen("libasound.so.2", RTLD_NOW | RTLD_LOCAL);
  if (!dl) dl = dlopen("libasound.so", RTLD_NOW | RTLD_LOCAL);
  if (!dl) return nullptr;
  auto sym = [&](const char* name) { return dlsym(dl, name); };
  api.pcm_open = (int (*)(void**, const char*, int, int))sym("snd_pcm_open");
  api.set_params = (int (*)(void*, int, int, unsigned, unsigned, int,
                            unsigned))sym("snd_pcm_set_params");
  api.readi = (long (*)(void*, void*, unsigned long))sym("snd_pcm_readi");
  api.writei =
      (long (*)(void*, const void*, unsigned long))sym("snd_pcm_writei");
  api.recover = (int (*)(void*, int, int))sym("snd_pcm_recover");
  api.prepare = (int (*)(void*))sym("snd_pcm_prepare");
  api.drain = (int (*)(void*))sym("snd_pcm_drain");
  api.close = (int (*)(void*))sym("snd_pcm_close");
  api.strerror_ = (const char* (*)(int))sym("snd_strerror");
  if (!api.pcm_open || !api.set_params || !api.readi || !api.writei ||
      !api.recover || !api.close) {
    dlclose(dl);
    return nullptr;
  }
  api.dl = dl;
  return &api;
}

struct BioAlsa {
  void* pcm = nullptr;
  int channels = 0;
  bool capture = false;
  long xruns = 0;
};

void set_err(char* errbuf, int errlen, const char* msg) {
  if (errbuf && errlen > 0) {
    snprintf(errbuf, (size_t)errlen, "%s", msg);
  }
}

}  // namespace

extern "C" {

int bio_alsa_runtime_available(void) { return alsa_api() != nullptr; }

// Open one PCM direction. capture=1 for the record stream (the reference's
// input ports, rosjack.cpp:234-250), 0 for playback (:252-270). Returns a
// handle or NULL; on failure errbuf holds a human-readable reason.
void* bio_alsa_open(const char* device, int capture, int channels, int rate,
                    int latency_us, char* errbuf, int errlen) {
  AlsaApi* api = alsa_api();
  if (!api) {
    set_err(errbuf, errlen,
            "libasound not present on this host (no ALSA runtime)");
    return nullptr;
  }
  void* pcm = nullptr;
  int rc = api->pcm_open(&pcm, device ? device : "default",
                         capture ? kSndPcmStreamCapture
                                 : kSndPcmStreamPlayback,
                         0 /* blocking */);
  if (rc < 0) {
    set_err(errbuf, errlen,
            api->strerror_ ? api->strerror_(rc) : "snd_pcm_open failed");
    return nullptr;
  }
  rc = api->set_params(pcm, kSndPcmFormatFloatLE, kSndPcmAccessRwInterleaved,
                       (unsigned)channels, (unsigned)rate, 1 /* resample */,
                       (unsigned)latency_us);
  if (rc < 0) {
    set_err(errbuf, errlen,
            api->strerror_ ? api->strerror_(rc) : "snd_pcm_set_params failed");
    api->close(pcm);
    return nullptr;
  }
  auto* h = new BioAlsa;
  h->pcm = pcm;
  h->channels = channels;
  h->capture = capture != 0;
  return h;
}

// Blocking interleaved-float read of exactly `frames` frames (short only at
// an unrecoverable error). Xruns are recovered and counted like the
// reference's jack_xrun_callback (rosjack.cpp:78-82).
long bio_alsa_read(void* handle, float* out, long frames) {
  auto* h = (BioAlsa*)handle;
  AlsaApi* api = alsa_api();
  long done = 0;
  while (done < frames) {
    long n = api->readi(h->pcm, out + done * h->channels,
                        (unsigned long)(frames - done));
    if (n < 0) {
      h->xruns++;
      if (api->recover(h->pcm, (int)n, 1 /* silent */) < 0) return done;
      continue;
    }
    done += n;
  }
  return done;
}

// Blocking interleaved-float write, same recovery/accounting as read.
long bio_alsa_write(void* handle, const float* in, long frames) {
  auto* h = (BioAlsa*)handle;
  AlsaApi* api = alsa_api();
  long done = 0;
  while (done < frames) {
    long n = api->writei(h->pcm, in + done * h->channels,
                         (unsigned long)(frames - done));
    if (n < 0) {
      h->xruns++;
      if (api->recover(h->pcm, (int)n, 1 /* silent */) < 0) return done;
      continue;
    }
    done += n;
  }
  return done;
}

long bio_alsa_xruns(void* handle) { return ((BioAlsa*)handle)->xruns; }

void bio_alsa_close(void* handle) {
  auto* h = (BioAlsa*)handle;
  AlsaApi* api = alsa_api();
  if (api && h->pcm) {
    if (!h->capture && api->drain) api->drain(h->pcm);
    api->close(h->pcm);
  }
  delete h;
}

}  // extern "C"

// ----------------------- JACK client adapter --------------------------------
// The literal JACK-graph role of the reference (rosjack.cpp:98-157 creates
// the client + ports and registers the real-time callback; :234-270
// auto-connects the physical capture/playback ports). Like the ALSA
// backend, libjack is bound AT RUNTIME via dlopen with a hand-declared ABI
// (the JACK C ABI has been stable for decades), so the library builds and
// loads on hosts with no JACK development environment, and
// bio_jack_runtime_available() reports whether a server library exists.
//
// Threading model: JACK invokes the process callback on ITS real-time
// thread. The callback only moves samples between the port buffers and two
// lock-free SPSC rings (the jack_ringbuffer pattern the reference uses for
// its output_type ROSJACK_OUT_JACK path) — capture frames are interleaved
// into cap_ring, playback frames are drained from play_ring (underrun plays
// silence, the decoupling-buffer semantics of jack_write.cpp:7-10). A
// capture overrun DROPS the period and counts it, JACK's own "miss the
// deadline, lose the period" contract (rosjack.cpp:78-82).
//
// Test hook: BEAMIO_JACK_LIB overrides the dlopen path so a fake libjack
// (csrc/fakejack.cpp) can stand in for a live server — hermetic tests drive
// the process callback by hand through it.

#include <ctime>

namespace {

constexpr int kJackNoStartServer = 0x01;
constexpr unsigned long kJackPortIsInput = 0x1;
constexpr unsigned long kJackPortIsOutput = 0x2;
constexpr unsigned long kJackPortIsPhysical = 0x4;
const char kJackAudioType[] = "32 bit float mono audio";

struct JackApi {
  void* dl = nullptr;
  std::string dl_path;  // retry when BEAMIO_JACK_LIB changes (test hook)
  void* (*client_open)(const char*, int, int*, ...) = nullptr;
  char* (*get_client_name)(void*) = nullptr;
  int (*set_process_callback)(void*, int (*)(uint32_t, void*), void*)
      = nullptr;
  void (*on_shutdown)(void*, void (*)(void*), void*) = nullptr;
  int (*set_xrun_callback)(void*, int (*)(void*), void*) = nullptr;
  uint32_t (*get_buffer_size)(void*) = nullptr;
  uint32_t (*get_sample_rate)(void*) = nullptr;
  void* (*port_register)(void*, const char*, const char*, unsigned long,
                         unsigned long) = nullptr;
  const char* (*port_name)(void*) = nullptr;
  void* (*port_get_buffer)(void*, uint32_t) = nullptr;
  int (*activate)(void*) = nullptr;
  int (*deactivate)(void*) = nullptr;
  int (*client_close)(void*) = nullptr;
  const char** (*get_ports)(void*, const char*, const char*, unsigned long)
      = nullptr;
  int (*connect_)(void*, const char*, const char*) = nullptr;
  void (*free_)(void*) = nullptr;
};

JackApi* jack_api() {
  static JackApi api;
  const char* env = getenv("BEAMIO_JACK_LIB");
  std::string want = env ? env : "";
  if (api.dl && api.dl_path == want) return &api;
  if (api.dl && api.dl_path != want) {  // test hook changed: rebind
    dlclose(api.dl);
    api.dl = nullptr;
  }
  void* dl = nullptr;
  if (env) dl = dlopen(env, RTLD_NOW | RTLD_LOCAL);
  if (!dl && !env) dl = dlopen("libjack.so.0", RTLD_NOW | RTLD_LOCAL);
  if (!dl && !env) dl = dlopen("libjack.so", RTLD_NOW | RTLD_LOCAL);
  if (!dl) return nullptr;
  auto sym = [&](const char* name) { return dlsym(dl, name); };
  api.client_open =
      (void* (*)(const char*, int, int*, ...))sym("jack_client_open");
  api.get_client_name = (char* (*)(void*))sym("jack_get_client_name");
  api.set_process_callback =
      (int (*)(void*, int (*)(uint32_t, void*), void*))
          sym("jack_set_process_callback");
  api.on_shutdown =
      (void (*)(void*, void (*)(void*), void*))sym("jack_on_shutdown");
  api.set_xrun_callback =
      (int (*)(void*, int (*)(void*), void*))sym("jack_set_xrun_callback");
  api.get_buffer_size = (uint32_t (*)(void*))sym("jack_get_buffer_size");
  api.get_sample_rate = (uint32_t (*)(void*))sym("jack_get_sample_rate");
  api.port_register =
      (void* (*)(void*, const char*, const char*, unsigned long,
                 unsigned long))sym("jack_port_register");
  api.port_name = (const char* (*)(void*))sym("jack_port_name");
  api.port_get_buffer =
      (void* (*)(void*, uint32_t))sym("jack_port_get_buffer");
  api.activate = (int (*)(void*))sym("jack_activate");
  api.deactivate = (int (*)(void*))sym("jack_deactivate");
  api.client_close = (int (*)(void*))sym("jack_client_close");
  api.get_ports =
      (const char** (*)(void*, const char*, const char*, unsigned long))
          sym("jack_get_ports");
  api.connect_ = (int (*)(void*, const char*, const char*))
      sym("jack_connect");
  api.free_ = (void (*)(void*))sym("jack_free");
  if (!api.client_open || !api.set_process_callback || !api.port_register ||
      !api.port_get_buffer || !api.activate || !api.client_close ||
      !api.get_sample_rate || !api.get_buffer_size || !api.port_name) {
    dlclose(dl);
    return nullptr;
  }
  api.dl = dl;
  api.dl_path = want;
  return &api;
}

struct BioJack {
  void* client = nullptr;
  std::vector<void*> in_ports;
  void* out_port = nullptr;
  int channels = 0;
  BioRing* cap_ring = nullptr;   // RT producer -> Python consumer
  BioRing* play_ring = nullptr;  // Python producer -> RT consumer
  std::vector<float> scratch;    // RT interleave buffer (preallocated)
  std::atomic<long> xruns{0};
  std::atomic<bool> dead{false};
  uint32_t sample_rate = 0;
  uint32_t buffer_size = 0;
};

int jack_process_cb(uint32_t nframes, void* arg) {
  auto* h = (BioJack*)arg;
  JackApi* api = jack_api();
  const int ch = h->channels;
  const size_t need = (size_t)nframes * ch;
  if (h->scratch.size() < need) h->scratch.resize(need);  // rare: server
  float* s = h->scratch.data();                           // resized buffers
  for (int c = 0; c < ch; ++c) {
    auto* in = (const float*)api->port_get_buffer(h->in_ports[c], nframes);
    for (uint32_t i = 0; i < nframes; ++i) s[i * ch + c] = in[i];
  }
  if (bio_ring_write(h->cap_ring, s, (long)need) < (long)need)
    h->xruns.fetch_add(1, std::memory_order_relaxed);  // consumer behind:
                                                       // period dropped
  auto* out = (float*)api->port_get_buffer(h->out_port, nframes);
  long got = bio_ring_read(h->play_ring, out, (long)nframes);
  if (got < (long)nframes)  // underrun: silence (decoupling-lag semantics)
    memset(out + got, 0, ((size_t)nframes - got) * sizeof(float));
  return 0;
}

void jack_shutdown_cb(void* arg) {
  ((BioJack*)arg)->dead.store(true, std::memory_order_release);
}

int jack_xrun_cb(void* arg) {
  ((BioJack*)arg)->xruns.fetch_add(1, std::memory_order_relaxed);
  return 0;
}

void bio_msleep(int ms) {
  struct timespec ts{0, ms * 1000000L};
  nanosleep(&ts, nullptr);
}

}  // namespace

extern "C" {

int bio_jack_runtime_available(void) { return jack_api() != nullptr; }

// Join an existing JACK graph as a client: register `channels` input ports
// + one output port, install the RT callback, activate, and (optionally)
// auto-connect to the first physical capture/playback ports — the exact
// rosjack_create sequence (rosjack.cpp:98-157,234-270). Returns a handle or
// NULL with a readable reason in errbuf. connected_in/out report how many
// physical ports were patched (the reference warns and continues when it
// runs out, rosjack.cpp:245-249).
void* bio_jack_open(const char* client_name, int channels, int auto_connect,
                    int connect_out, int* sample_rate, int* buffer_size,
                    int* connected_in, int* connected_out,
                    char* errbuf, int errlen) {
  JackApi* api = jack_api();
  if (!api) {
    set_err(errbuf, errlen,
            "libjack not present on this host (no JACK runtime)");
    return nullptr;
  }
  int status = 0;
  void* client = api->client_open(client_name ? client_name : "beamform_tpu",
                                  kJackNoStartServer, &status);
  if (!client) {
    snprintf(errbuf ? errbuf : (char*)"", errbuf ? (size_t)errlen : 0,
             "jack_client_open failed, status=0x%x (no JACK server running?)",
             status);
    return nullptr;
  }
  auto* h = new BioJack;
  h->client = client;
  h->channels = channels;
  h->sample_rate = api->get_sample_rate(client);
  h->buffer_size = api->get_buffer_size(client);
  // ring capacity: ~2 s of decoupling at 48 kHz — the 50-window playback
  // buffer scale of jack_write.cpp:7-10
  long cap = (long)h->sample_rate * 2 * (channels > 0 ? channels : 1);
  h->cap_ring = (BioRing*)bio_ring_create(cap);
  h->play_ring = (BioRing*)bio_ring_create((long)h->sample_rate * 2);
  h->scratch.resize((size_t)h->buffer_size * channels);
  char pname[64];
  for (int c = 0; c < channels; ++c) {
    snprintf(pname, sizeof(pname), "input_%d", c + 1);  // rosjack.cpp:252
    void* p = api->port_register(client, pname, kJackAudioType,
                                 kJackPortIsInput, 0);
    if (!p) {
      set_err(errbuf, errlen, "jack_port_register(input) failed");
      api->client_close(client);
      delete h;
      return nullptr;
    }
    h->in_ports.push_back(p);
  }
  h->out_port = api->port_register(client, "output", kJackAudioType,
                                   kJackPortIsOutput, 0);
  if (!h->out_port) {
    set_err(errbuf, errlen, "jack_port_register(output) failed");
    api->client_close(client);
    delete h;
    return nullptr;
  }
  api->set_process_callback(client, jack_process_cb, h);
  if (api->on_shutdown) api->on_shutdown(client, jack_shutdown_cb, h);
  if (api->set_xrun_callback)
    api->set_xrun_callback(client, jack_xrun_cb, h);
  if (api->activate(client) != 0) {
    set_err(errbuf, errlen, "jack_activate failed");
    api->client_close(client);
    delete h;
    return nullptr;
  }
  int conn_in = 0, conn_out = 0;
  if (auto_connect && api->get_ports && api->connect_) {
    const char** names = api->get_ports(
        client, nullptr, nullptr, kJackPortIsPhysical | kJackPortIsOutput);
    if (names) {
      for (int c = 0; c < channels && names[c]; ++c) {
        if (api->connect_(client, names[c],
                          api->port_name(h->in_ports[c])) == 0)
          ++conn_in;
        else
          break;  // reference: warn, keep the ones that connected
      }
      if (api->free_) api->free_((void*)names);
    }
  }
  if (connect_out && api->get_ports && api->connect_) {
    const char** names = api->get_ports(
        client, nullptr, nullptr, kJackPortIsPhysical | kJackPortIsInput);
    if (names) {
      if (names[0] && api->connect_(client, api->port_name(h->out_port),
                                    names[0]) == 0)
        ++conn_out;
      if (api->free_) api->free_((void*)names);
    }
  }
  if (sample_rate) *sample_rate = (int)h->sample_rate;
  if (buffer_size) *buffer_size = (int)h->buffer_size;
  if (connected_in) *connected_in = conn_in;
  if (connected_out) *connected_out = conn_out;
  return h;
}

// Blocking interleaved-float capture of `frames` frames from the RT ring.
// Returns short only when the server died (shutdown callback) or stalled
// >5 s — callers treat short as a dead graph, like the ALSA dead-device
// contract.
long bio_jack_read(void* handle, float* out, long frames) {
  auto* h = (BioJack*)handle;
  const long need = frames * h->channels;
  long done = 0;
  int stalled_ms = 0;
  while (done < need) {
    long n = bio_ring_read(h->cap_ring, out + done, need - done);
    done += n;
    if (done >= need) break;
    if (h->dead.load(std::memory_order_acquire)) break;
    if (n == 0) {
      if (stalled_ms >= 5000) break;
      bio_msleep(1);
      stalled_ms += 1;
    } else {
      stalled_ms = 0;
    }
  }
  return done / (h->channels ? h->channels : 1);
}

// Blocking mono playback into the RT ring (backpressure: waits for space).
long bio_jack_write(void* handle, const float* in, long frames) {
  auto* h = (BioJack*)handle;
  long done = 0;
  int stalled_ms = 0;
  while (done < frames) {
    long n = bio_ring_write(h->play_ring, in + done, frames - done);
    done += n;
    if (done >= frames) break;
    if (h->dead.load(std::memory_order_acquire)) break;
    if (n == 0) {
      if (stalled_ms >= 5000) break;
      bio_msleep(1);
      stalled_ms += 1;
    } else {
      stalled_ms = 0;
    }
  }
  return done;
}

long bio_jack_xruns(void* handle) {
  return ((BioJack*)handle)->xruns.load(std::memory_order_relaxed);
}

int bio_jack_alive(void* handle) {
  return !((BioJack*)handle)->dead.load(std::memory_order_acquire);
}

void bio_jack_close(void* handle) {
  auto* h = (BioJack*)handle;
  JackApi* api = jack_api();
  if (api && h->client) {
    if (api->deactivate) api->deactivate(h->client);
    api->client_close(h->client);
  }
  bio_ring_free(h->cap_ring);
  bio_ring_free(h->play_ring);
  delete h;
}

const char* bio_version() { return "beamio 0.3.0"; }

}  // extern "C"
