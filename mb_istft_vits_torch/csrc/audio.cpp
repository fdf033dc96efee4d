// Native data-loader core: WAV (RIFF PCM16 mono) decode + windowed-FFT
// linear spectrogram, OpenMP over frames.
//
// The port's copy of the JAX package's native/audio.cpp: the reference's
// torch DataLoader worker path (data_utils.py:78-86: wav read ->
// spectrogram_torch -> disk cache) as a plain C ABI, built with g++ by
// mb_istft_vits_torch/utils/native_build.py and bound with ctypes in
// mb_istft_vits_torch/data/native_audio.py. Host code for the loader
// threads, not a device kernel.
//
// Spectrogram semantics match dsp/stft.py::spectrogram (itself matching the
// reference mel_processing.py:51-70): constant-pad (n_fft-hop)/2 both
// sides, center=False framing, periodic Hann window (win zero-padded
// centered to n_fft), onesided |rfft|.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

bool read_exact(FILE* f, void* dst, size_t n) {
    return fread(dst, 1, n, f) == n;
}

struct WavInfo {
    int sample_rate = 0;
    int channels = 0;
    int bits = 0;
    int format = 0;  // 1 = PCM int, 3 = IEEE float
    long data_offset = 0;
    long data_bytes = 0;
};

// Parse RIFF/WAVE chunks; returns false on malformed/unsupported container.
bool parse_wav(FILE* f, WavInfo* info) {
    char tag[4];
    uint32_t sz;
    if (!read_exact(f, tag, 4) || memcmp(tag, "RIFF", 4)) return false;
    if (!read_exact(f, &sz, 4)) return false;
    if (!read_exact(f, tag, 4) || memcmp(tag, "WAVE", 4)) return false;
    while (read_exact(f, tag, 4) && read_exact(f, &sz, 4)) {
        if (!memcmp(tag, "fmt ", 4)) {
            uint16_t fmt, ch, block, bits;
            uint32_t rate, byterate;
            if (sz < 16) return false;
            if (!read_exact(f, &fmt, 2) || !read_exact(f, &ch, 2) ||
                !read_exact(f, &rate, 4) || !read_exact(f, &byterate, 4) ||
                !read_exact(f, &block, 2) || !read_exact(f, &bits, 2))
                return false;
            info->format = fmt;
            info->channels = ch;
            info->sample_rate = (int)rate;
            info->bits = bits;
            // skip fmt extension + the RIFF odd-size pad byte (same as
            // the generic chunk skip below — omitting it desyncs every
            // later chunk read for odd-sized WAVEFORMATEXTENSIBLE fmts)
            if (sz > 16 && fseek(f, (long)(sz - 16) + (sz & 1), SEEK_CUR))
                return false;
        } else if (!memcmp(tag, "data", 4)) {
            info->data_offset = ftell(f);
            info->data_bytes = sz;
            return info->sample_rate > 0;
        } else {
            if (fseek(f, (long)sz + (sz & 1), SEEK_CUR)) return false;
        }
    }
    return false;
}

}  // namespace

extern "C" {

// Number of mono samples in a supported wav, or -1 if the file is missing
// or not PCM16/float32 mono (caller falls back to the Python reader).
// *sample_rate is set on success.
long wav_info(const char* path, int* sample_rate) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    WavInfo info;
    bool ok = parse_wav(f, &info);
    fclose(f);
    if (!ok || info.channels != 1) return -1;
    if (!((info.format == 1 && info.bits == 16) ||
          (info.format == 3 && info.bits == 32)))
        return -1;
    *sample_rate = info.sample_rate;
    return info.data_bytes / (info.bits / 8);
}

// Read mono samples into out[n] as float32 raw values (int16 range for
// PCM16, [-1,1] for float wavs — matching scipy.io.wavfile.read dtypes).
// Returns samples written, or -1.
long wav_read(const char* path, float* out, long cap) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    WavInfo info;
    // full format validation BEFORE the bits division: a malformed fmt
    // chunk declaring bits == 0 would otherwise SIGFPE the process
    // instead of returning the documented -1 fallback
    if (!parse_wav(f, &info) || info.channels != 1 ||
        !((info.format == 1 && info.bits == 16) ||
          (info.format == 3 && info.bits == 32))) {
        fclose(f);
        return -1;
    }
    long n = info.data_bytes / (info.bits / 8);
    if (n > cap) n = cap;
    if (fseek(f, info.data_offset, SEEK_SET)) {
        fclose(f);
        return -1;
    }
    if (info.format == 1 && info.bits == 16) {
        std::vector<int16_t> buf(n);
        if (!read_exact(f, buf.data(), (size_t)n * 2)) {
            fclose(f);
            return -1;
        }
        for (long i = 0; i < n; i++) out[i] = (float)buf[i];
    } else if (info.format == 3 && info.bits == 32) {
        if (!read_exact(f, out, (size_t)n * 4)) {
            fclose(f);
            return -1;
        }
    } else {
        fclose(f);
        return -1;
    }
    fclose(f);
    return n;
}

// Linear magnitude spectrogram, out[frames * (n_fft/2+1)], frame-major.
// Returns n_frames, or -1 (n_fft not a power of two / win > n_fft).
// y is the normalized signal; frames = 1 + (n + 2p - n_fft)/hop with
// p = (n_fft - hop)/2 (constant zero padding).
long spectrogram_f32(const float* y, long n, int n_fft, int hop, int win,
                     float* out) {
    if (n_fft & (n_fft - 1)) return -1;  // radix-2 only
    if (win > n_fft || hop <= 0 || n <= 0) return -1;
    int n_bins = n_fft / 2 + 1;
    long p = (n_fft - hop) / 2;
    long padded = n + 2 * p;
    if (padded < n_fft) return -1;
    long frames = 1 + (padded - n_fft) / hop;

    // periodic Hann over `win`, zero-padded centered to n_fft
    std::vector<double> window(n_fft, 0.0);
    int left = (n_fft - win) / 2;
    for (int i = 0; i < win; i++)
        window[left + i] = 0.5 - 0.5 * cos(2.0 * M_PI * i / win);

    // twiddles + bit-reversal for iterative radix-2 FFT
    int levels = 0;
    while ((1 << levels) < n_fft) levels++;
    std::vector<double> cos_t(n_fft / 2), sin_t(n_fft / 2);
    for (int i = 0; i < n_fft / 2; i++) {
        cos_t[i] = cos(2.0 * M_PI * i / n_fft);
        sin_t[i] = -sin(2.0 * M_PI * i / n_fft);
    }
    std::vector<int> rev(n_fft);
    for (int i = 0; i < n_fft; i++) {
        int r = 0;
        for (int j = 0; j < levels; j++) r |= ((i >> j) & 1) << (levels - 1 - j);
        rev[i] = r;
    }

#pragma omp parallel
    {
        std::vector<double> re(n_fft), im(n_fft);
#pragma omp for
        for (long t = 0; t < frames; t++) {
            long start = t * hop - p;  // into the unpadded signal
            for (int i = 0; i < n_fft; i++) {
                long s = start + i;
                double v = (s >= 0 && s < n) ? (double)y[s] : 0.0;
                re[rev[i]] = v * window[i];
                im[rev[i]] = 0.0;
            }
            for (int size = 2; size <= n_fft; size <<= 1) {
                int half = size >> 1;
                int step = n_fft / size;
                for (int i = 0; i < n_fft; i += size) {
                    for (int j = i, k = 0; j < i + half; j++, k += step) {
                        double tr = re[j + half] * cos_t[k] -
                                    im[j + half] * sin_t[k];
                        double ti = re[j + half] * sin_t[k] +
                                    im[j + half] * cos_t[k];
                        re[j + half] = re[j] - tr;
                        im[j + half] = im[j] - ti;
                        re[j] += tr;
                        im[j] += ti;
                    }
                }
            }
            float* row = out + t * n_bins;
            for (int k = 0; k < n_bins; k++)
                row[k] = (float)sqrt(re[k] * re[k] + im[k] * im[k]);
        }
    }
    return frames;
}

}  // extern "C"
