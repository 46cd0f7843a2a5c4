// ffshim.cpp — thin C bindings over the system FFmpeg (libavcodec) used ONLY
// as an independent third-party implementation for cross-validation and for
// MP3→PCM decode.
//
// Why this exists: every parity claim in this
// repo used to be oracle ↔ native ↔ device over streams produced by our own
// encoders.  FFmpeg ships independent decoders for both reference codecs —
// `msvideo1` (CRAM, MSVideo1.hx) and `scpr` (ScreenPressor v1/v2/v3,
// ScreenPressor.hx) — plus an `msvideo1` *encoder*, so we can (a) decode our
// encoder's streams with FFmpeg and (b) decode genuine third-party streams
// with our decoders.  The MP3→PCM path mirrors the reference delegating audio
// decode to the browser's WebAudio (AudioTrack.hx:54-65): we delegate to the
// system codec library instead of hand-rolling a Layer-III decoder.
//
// All entry points are plain-C, loaded via ctypes (see ffshim.py).  The shim
// is optional: if libavcodec is absent the build fails and Python callers
// gate on availability.

#include <cstdint>
#include <cstring>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libavutil/pixdesc.h>
}

namespace {

struct VDec {
    const AVCodec *codec = nullptr;
    AVCodecContext *ctx = nullptr;
    AVFrame *frame = nullptr;
    AVPacket *pkt = nullptr;
};

struct VEnc {
    const AVCodec *codec = nullptr;
    AVCodecContext *ctx = nullptr;
    AVFrame *frame = nullptr;
    AVPacket *pkt = nullptr;
    int64_t pts = 0;
};

struct ADec {
    const AVCodec *codec = nullptr;
    AVCodecContext *ctx = nullptr;
    AVFrame *frame = nullptr;
    AVPacket *pkt = nullptr;
};

int bytes_per_pixel(AVPixelFormat fmt) {
    switch (fmt) {
    case AV_PIX_FMT_PAL8: return 1;
    case AV_PIX_FMT_RGB555LE:
    case AV_PIX_FMT_RGB555BE:
    case AV_PIX_FMT_RGB565LE: return 2;
    case AV_PIX_FMT_RGB24:
    case AV_PIX_FMT_BGR24: return 3;
    case AV_PIX_FMT_RGB0:
    case AV_PIX_FMT_BGR0:
    case AV_PIX_FMT_RGBA:
    case AV_PIX_FMT_BGRA:
    case AV_PIX_FMT_0RGB:
    case AV_PIX_FMT_0BGR: return 4;
    default: return 0;
    }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Video decode (msvideo1 / scpr / anything raw-packet based)
// ---------------------------------------------------------------------------

// Open a named decoder for raw AVI-style packets.  `fourcc` is the codec_tag
// (0 for none); `bpp` feeds bits_per_coded_sample, which both msvideo1 and
// scpr use to pick their pixel format (PAL8/RGB555 vs RGB555/BGR0).
void *ffv_open(const char *codec_name, int width, int height, int bpp,
               uint32_t fourcc, const uint8_t *extradata, int extradata_size) {
    const AVCodec *codec = avcodec_find_decoder_by_name(codec_name);
    if (!codec) return nullptr;
    VDec *d = new VDec;
    d->codec = codec;
    d->ctx = avcodec_alloc_context3(codec);
    d->ctx->width = width;
    d->ctx->height = height;
    d->ctx->codec_tag = fourcc;
    d->ctx->bits_per_coded_sample = bpp;
    if (extradata && extradata_size > 0) {
        d->ctx->extradata = (uint8_t *)av_mallocz(
            extradata_size + AV_INPUT_BUFFER_PADDING_SIZE);
        memcpy(d->ctx->extradata, extradata, extradata_size);
        d->ctx->extradata_size = extradata_size;
    }
    if (avcodec_open2(d->ctx, codec, nullptr) < 0) {
        avcodec_free_context(&d->ctx);
        delete d;
        return nullptr;
    }
    d->frame = av_frame_alloc();
    d->pkt = av_packet_alloc();
    return d;
}

// Decode one packet.  Returns:
//   >0  bytes written to `out` (packed rows, bytes_per_pixel * width per row)
//    0  decoder consumed the packet but produced no frame
//   <0  error
// `pal_rgba`: optional 256*4 B8G8R8A8 (AVPacket palette side-data layout) for
// PAL8 codecs; attached as AV_PKT_DATA_PALETTE.
// On success `fmt_name` (if non-null, cap `fmt_cap`) gets the pixel format
// name, and for PAL8 the frame's 1024-byte palette is appended after the
// pixel rows in `out`.
int ffv_decode(void *h, const uint8_t *data, int size, int is_key,
               const uint8_t *pal_rgba, uint8_t *out, long out_cap,
               char *fmt_name, int fmt_cap) {
    VDec *d = (VDec *)h;
    av_packet_unref(d->pkt);
    uint8_t *buf = (uint8_t *)av_malloc(size + AV_INPUT_BUFFER_PADDING_SIZE);
    if (!buf) return -1;
    memcpy(buf, data, size);
    memset(buf + size, 0, AV_INPUT_BUFFER_PADDING_SIZE);
    if (av_packet_from_data(d->pkt, buf, size) < 0) {
        av_free(buf);
        return -1;
    }
    if (is_key) d->pkt->flags |= AV_PKT_FLAG_KEY;
    if (pal_rgba) {
        uint8_t *sd = av_packet_new_side_data(d->pkt, AV_PKT_DATA_PALETTE,
                                              AVPALETTE_SIZE);
        if (!sd) return -1;
        memcpy(sd, pal_rgba, AVPALETTE_SIZE);
    }
    int ret = avcodec_send_packet(d->ctx, d->pkt);
    if (ret < 0) return ret;
    ret = avcodec_receive_frame(d->ctx, d->frame);
    if (ret == AVERROR(EAGAIN)) return 0;
    if (ret < 0) return ret;

    AVPixelFormat fmt = (AVPixelFormat)d->frame->format;
    int bpp = bytes_per_pixel(fmt);
    if (bpp == 0) return -1000;  // unsupported output format
    if (fmt_name && fmt_cap > 0) {
        const char *n = av_get_pix_fmt_name(fmt);
        strncpy(fmt_name, n ? n : "?", fmt_cap - 1);
        fmt_name[fmt_cap - 1] = 0;
    }
    int w = d->frame->width, hgt = d->frame->height;
    long need = (long)w * hgt * bpp + (fmt == AV_PIX_FMT_PAL8 ? 1024 : 0);
    if (need > out_cap) return -1001;
    for (int y = 0; y < hgt; y++)
        memcpy(out + (long)y * w * bpp,
               d->frame->data[0] + (long)y * d->frame->linesize[0],
               (long)w * bpp);
    if (fmt == AV_PIX_FMT_PAL8)
        memcpy(out + (long)w * hgt, d->frame->data[1], 1024);
    return (int)need;
}

void ffv_close(void *h) {
    VDec *d = (VDec *)h;
    if (d->ctx) avcodec_free_context(&d->ctx);
    if (d->frame) av_frame_free(&d->frame);
    if (d->pkt) av_packet_free(&d->pkt);
    delete d;
}

// ---------------------------------------------------------------------------
// MSVideo1 encode (FFmpeg's encoder: RGB555 in, CRAM packets out)
// ---------------------------------------------------------------------------

void *ffe_open(const char *codec_name, int width, int height) {
    const AVCodec *codec = avcodec_find_encoder_by_name(codec_name);
    if (!codec) return nullptr;
    VEnc *e = new VEnc;
    e->codec = codec;
    e->ctx = avcodec_alloc_context3(codec);
    e->ctx->width = width;
    e->ctx->height = height;
    e->ctx->time_base = {1, 15};
    e->ctx->pix_fmt = codec->pix_fmts ? codec->pix_fmts[0]
                                      : AV_PIX_FMT_RGB555;
    if (avcodec_open2(e->ctx, codec, nullptr) < 0) {
        avcodec_free_context(&e->ctx);
        delete e;
        return nullptr;
    }
    e->frame = av_frame_alloc();
    e->frame->format = e->ctx->pix_fmt;
    e->frame->width = width;
    e->frame->height = height;
    if (av_frame_get_buffer(e->frame, 0) < 0) {
        avcodec_free_context(&e->ctx);
        av_frame_free(&e->frame);
        delete e;
        return nullptr;
    }
    e->pkt = av_packet_alloc();
    return e;
}

int ffe_pix_fmt_name(void *h, char *name, int cap) {
    VEnc *e = (VEnc *)h;
    const char *n = av_get_pix_fmt_name(e->ctx->pix_fmt);
    if (!n) return -1;
    strncpy(name, n, cap - 1);
    name[cap - 1] = 0;
    return 0;
}

// Encode one packed frame (rows of width*bytes_per_pixel).  Returns packet
// size written to `out` (>0), 0 if no packet yet, <0 on error.  `*is_key`
// gets the keyframe flag.
int ffe_encode(void *h, const uint8_t *frame_data, uint8_t *out, long out_cap,
               int *is_key) {
    VEnc *e = (VEnc *)h;
    int bpp = bytes_per_pixel(e->ctx->pix_fmt);
    if (bpp == 0) return -1000;
    if (av_frame_make_writable(e->frame) < 0) return -1;
    for (int y = 0; y < e->ctx->height; y++)
        memcpy(e->frame->data[0] + (long)y * e->frame->linesize[0],
               frame_data + (long)y * e->ctx->width * bpp,
               (long)e->ctx->width * bpp);
    e->frame->pts = e->pts++;
    int ret = avcodec_send_frame(e->ctx, e->frame);
    if (ret < 0) return ret;
    ret = avcodec_receive_packet(e->ctx, e->pkt);
    if (ret == AVERROR(EAGAIN)) return 0;
    if (ret < 0) return ret;
    if (e->pkt->size > out_cap) return -1001;
    memcpy(out, e->pkt->data, e->pkt->size);
    *is_key = (e->pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0;
    int n = e->pkt->size;
    av_packet_unref(e->pkt);
    return n;
}

void ffe_close(void *h) {
    VEnc *e = (VEnc *)h;
    if (e->ctx) avcodec_free_context(&e->ctx);
    if (e->frame) av_frame_free(&e->frame);
    if (e->pkt) av_packet_free(&e->pkt);
    delete e;
}

// ---------------------------------------------------------------------------
// MP3 → PCM float32 (interleaved).  One MP3 frame per call, like the
// reference feeding WebAudio one section at a time (MP3Parser.hx:242-255).
// ---------------------------------------------------------------------------

void *ffa_open(void) {
    const AVCodec *codec = avcodec_find_decoder(AV_CODEC_ID_MP3);
    if (!codec) return nullptr;
    ADec *a = new ADec;
    a->codec = codec;
    a->ctx = avcodec_alloc_context3(codec);
    if (avcodec_open2(a->ctx, codec, nullptr) < 0) {
        avcodec_free_context(&a->ctx);
        delete a;
        return nullptr;
    }
    a->frame = av_frame_alloc();
    a->pkt = av_packet_alloc();
    return a;
}

// Returns number of samples-per-channel written (>=0) or <0 on error.
// Output is float32 interleaved [nsamples, channels]; `*sample_rate` and
// `*channels` are set when a frame is produced.
int ffa_decode(void *h, const uint8_t *data, int size, float *out,
               long out_cap_floats, int *sample_rate, int *channels) {
    ADec *a = (ADec *)h;
    av_packet_unref(a->pkt);
    uint8_t *buf = (uint8_t *)av_malloc(size + AV_INPUT_BUFFER_PADDING_SIZE);
    if (!buf) return -1;
    memcpy(buf, data, size);
    memset(buf + size, 0, AV_INPUT_BUFFER_PADDING_SIZE);
    if (av_packet_from_data(a->pkt, buf, size) < 0) {
        av_free(buf);
        return -1;
    }
    int ret = avcodec_send_packet(a->ctx, a->pkt);
    if (ret < 0) return ret;
    int total = 0;
    for (;;) {
        ret = avcodec_receive_frame(a->ctx, a->frame);
        if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) break;
        if (ret < 0) return ret;
        int ns = a->frame->nb_samples;
        int nc = a->frame->ch_layout.nb_channels;
        *sample_rate = a->frame->sample_rate;
        *channels = nc;
        if ((long)(total + ns) * nc > out_cap_floats) return -1001;
        if (a->frame->format == AV_SAMPLE_FMT_FLTP) {
            for (int c = 0; c < nc; c++) {
                const float *src = (const float *)a->frame->data[c];
                for (int i = 0; i < ns; i++)
                    out[(long)(total + i) * nc + c] = src[i];
            }
        } else if (a->frame->format == AV_SAMPLE_FMT_S16P) {
            for (int c = 0; c < nc; c++) {
                const int16_t *src = (const int16_t *)a->frame->data[c];
                for (int i = 0; i < ns; i++)
                    out[(long)(total + i) * nc + c] = src[i] / 32768.0f;
            }
        } else if (a->frame->format == AV_SAMPLE_FMT_S16) {
            const int16_t *src = (const int16_t *)a->frame->data[0];
            for (long i = 0; i < (long)ns * nc; i++)
                out[(long)total * nc + i] = src[i] / 32768.0f;
        } else if (a->frame->format == AV_SAMPLE_FMT_FLT) {
            memcpy(out + (long)total * nc, a->frame->data[0],
                   (long)ns * nc * sizeof(float));
        } else {
            return -1002;
        }
        total += ns;
    }
    return total;
}

void ffa_close(void *h) {
    ADec *a = (ADec *)h;
    if (a->ctx) avcodec_free_context(&a->ctx);
    if (a->frame) av_frame_free(&a->frame);
    if (a->pkt) av_packet_free(&a->pkt);
    delete a;
}

}  // extern "C"
