// turbodemux: native demux+decode shim over libavformat/libavcodec.
//
// This rebuild's host-side "native" component (the role the reference
// fills with cudarse-video/NVDEC + codec-bitstream, see SURVEY.md section 7):
// demux any container, decode on CPU, hand planar YUV + colour metadata to
// Python through a minimal C ABI (loaded with ctypes).  Frames are copied
// into caller-provided buffers so Python keeps ownership and can overlap
// decode with device compute.
//
// Build: g++ -O2 -shared -fPIC turbodemux.cpp -o libturbodemux.so
//        -lavformat -lavcodec -lavutil

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/pixdesc.h>
}

#include <cstdint>
#include <cstring>

struct TmHandle {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* dec = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    AVIOContext* avio = nullptr;  // set for callback-driven (stream) input
    int stream_index = -1;
    int eof = 0;
    // Currently negotiated output geometry/format.  Mid-stream changes
    // (new sequence header / SPS) update these and surface as a -3
    // "reconfigured" return with the frame stashed (pending=1), mirroring
    // NVDEC's sequence-callback-driven reconfiguration
    // (cudarse-video/src/dec.rs:172-195) but completing it: the caller
    // re-reads tm_info, resizes buffers, and the next tm_next_frame call
    // delivers the stashed frame.
    int cur_w = 0;
    int cur_h = 0;
    int cur_fmt = AV_PIX_FMT_NONE;
    int pending = 0;
};

struct TmInfo {
    int32_t width;
    int32_t height;
    int32_t depth;            // bits per luma sample
    int32_t chroma;           // 420, 422, 444, or 400 (gray)
    int32_t color_primaries;  // H.273 code points
    int32_t color_trc;
    int32_t color_space;
    int32_t full_range;       // 0 limited, 1 full, -1 unspecified
    int64_t frame_count;      // container estimate, 0 if unknown
    char codec_name[32];
    char container_name[32];
    // Timing (for chunked/seeking decode): stream time_base and the
    // average frame rate as rationals; zero denominators if unknown.
    int32_t time_base_num;
    int32_t time_base_den;
    int32_t fps_num;
    int32_t fps_den;
    // Stream start offset in time_base units (0 if unknown).  Containers
    // like MPEG-TS start at a nonzero PTS; frame-index <-> PTS mappings
    // must subtract it or chunked seeks land ~start_pts/fps frames off.
    int64_t start_pts;
};

// Caller-supplied IO callbacks for streaming input (stdin, pipes, Python
// file objects) — the role NVDEC's pull-mode demuxer feeding plays in the
// reference, without requiring a seekable file.
typedef int (*tm_read_cb)(void* opaque, uint8_t* buf, int len);
typedef int64_t (*tm_seek_cb)(void* opaque, int64_t offset, int whence);

struct TmIoShim {
    tm_read_cb read_cb;
    tm_seek_cb seek_cb;
    void* opaque;
};

static int tm_io_read(void* opaque, uint8_t* buf, int len) {
    auto* io = (TmIoShim*)opaque;
    int n = io->read_cb(io->opaque, buf, len);
    if (n == 0) return AVERROR_EOF;
    if (n < 0) return AVERROR(EIO);
    return n;
}

static int64_t tm_io_seek(void* opaque, int64_t offset, int whence) {
    auto* io = (TmIoShim*)opaque;
    return io->seek_cb(io->opaque, offset, whence);
}

static void tm_free(TmHandle* h) {
    av_frame_free(&h->frame);
    av_packet_free(&h->pkt);
    avcodec_free_context(&h->dec);
    avformat_close_input(&h->fmt);
    if (h->avio) {
        av_freep(&h->avio->buffer);
        delete (TmIoShim*)h->avio->opaque;
        avio_context_free(&h->avio);
    }
    delete h;
}

// Shared tail of tm_open/tm_open_io: pick the video stream, open the
// decoder, initialise the negotiated format.
static TmHandle* tm_setup(TmHandle* h) {
    if (avformat_find_stream_info(h->fmt, nullptr) < 0) {
        tm_free(h);
        return nullptr;
    }
    const AVCodec* codec = nullptr;
    h->stream_index =
        av_find_best_stream(h->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
    if (h->stream_index < 0 || !codec) {
        tm_free(h);
        return nullptr;
    }
    AVStream* st = h->fmt->streams[h->stream_index];
    h->dec = avcodec_alloc_context3(codec);
    avcodec_parameters_to_context(h->dec, st->codecpar);
    h->dec->thread_count = 0;  // auto
    if (avcodec_open2(h->dec, codec, nullptr) < 0) {
        tm_free(h);
        return nullptr;
    }
    h->pkt = av_packet_alloc();
    h->frame = av_frame_alloc();
    h->cur_w = st->codecpar->width;
    h->cur_h = st->codecpar->height;
    h->cur_fmt = st->codecpar->format;
    return h;
}

extern "C" {

TmHandle* tm_open(const char* path) {
    auto* h = new TmHandle();
    if (avformat_open_input(&h->fmt, path, nullptr, nullptr) < 0) {
        delete h;
        return nullptr;
    }
    return tm_setup(h);
}

// Streaming variant: demux via read (and optional seek) callbacks instead of
// a file path.  seek_cb may be null for non-seekable sources (stdin).
TmHandle* tm_open_io(tm_read_cb read_cb, tm_seek_cb seek_cb, void* opaque) {
    if (!read_cb) return nullptr;
    auto* h = new TmHandle();
    auto* io = new TmIoShim{read_cb, seek_cb, opaque};
    constexpr int kBufSize = 1 << 16;
    uint8_t* buf = (uint8_t*)av_malloc(kBufSize);
    h->avio = avio_alloc_context(buf, kBufSize, 0, io, tm_io_read, nullptr,
                                 seek_cb ? tm_io_seek : nullptr);
    if (!h->avio) {
        av_freep(&buf);
        delete io;
        delete h;
        return nullptr;
    }
    h->fmt = avformat_alloc_context();
    h->fmt->pb = h->avio;
    if (avformat_open_input(&h->fmt, nullptr, nullptr, nullptr) < 0) {
        // avformat_open_input frees h->fmt on failure but not the avio ctx.
        av_freep(&h->avio->buffer);
        delete io;
        avio_context_free(&h->avio);
        delete h;
        return nullptr;
    }
    return tm_setup(h);
}

int tm_info(TmHandle* h, TmInfo* out) {
    if (!h || !out) return -1;
    AVStream* st = h->fmt->streams[h->stream_index];
    AVCodecParameters* par = st->codecpar;
    out->width = h->cur_w ? h->cur_w : par->width;
    out->height = h->cur_h ? h->cur_h : par->height;
    AVPixelFormat pf = (AVPixelFormat)h->cur_fmt;
    if (pf == AV_PIX_FMT_NONE) pf = (AVPixelFormat)par->format;
    if (pf == AV_PIX_FMT_NONE) pf = h->dec->pix_fmt;
    const AVPixFmtDescriptor* desc = av_pix_fmt_desc_get(pf);
    out->depth = desc ? desc->comp[0].depth : 8;
    if (!desc || desc->nb_components == 1) {
        out->chroma = 400;
    } else if (desc->log2_chroma_w == 1 && desc->log2_chroma_h == 1) {
        out->chroma = 420;
    } else if (desc->log2_chroma_w == 1) {
        out->chroma = 422;
    } else {
        out->chroma = 444;
    }
    out->color_primaries = (int32_t)par->color_primaries;
    out->color_trc = (int32_t)par->color_trc;
    out->color_space = (int32_t)par->color_space;
    out->full_range = par->color_range == AVCOL_RANGE_JPEG
                          ? 1
                          : (par->color_range == AVCOL_RANGE_MPEG ? 0 : -1);
    out->frame_count = st->nb_frames;
    if (!out->frame_count && st->duration > 0 && st->avg_frame_rate.num > 0) {
        out->frame_count = av_rescale_q(st->duration, st->time_base,
                                        av_inv_q(st->avg_frame_rate));
    }
    snprintf(out->codec_name, sizeof(out->codec_name), "%s",
             avcodec_get_name(par->codec_id));
    snprintf(out->container_name, sizeof(out->container_name), "%s",
             h->fmt->iformat ? h->fmt->iformat->name : "?");
    out->time_base_num = st->time_base.num;
    out->time_base_den = st->time_base.den;
    out->fps_num = st->avg_frame_rate.num;
    out->fps_den = st->avg_frame_rate.den;
    out->start_pts = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;
    return 0;
}

// Copy a decoded plane into dst (tightly packed, h rows of w samples of
// `bytes` bytes each).
static void copy_plane(const uint8_t* src, int src_linesize, uint8_t* dst,
                       int w, int h, int bytes) {
    int row = w * bytes;
    for (int y = 0; y < h; y++) {
        memcpy(dst + (size_t)y * row, src + (size_t)y * src_linesize, row);
    }
}

// Returns 1 on frame, 0 on EOF, <0 on error.  Caller buffers must be sized
// w*h (luma) and cw*ch (each chroma plane) samples of ceil(depth/8) bytes.
// *pts (optional) receives the frame's best-effort timestamp in stream
// time_base units (AV_NOPTS_VALUE if unknown).
int tm_next_frame(TmHandle* h, uint8_t* y, uint8_t* u, uint8_t* v,
                  int64_t* pts) {
    if (!h) return -1;
    if (!h->pending) {
        while (true) {
            int ret = avcodec_receive_frame(h->dec, h->frame);
            if (ret == 0) break;
            if (ret == AVERROR_EOF) return 0;
            if (ret != AVERROR(EAGAIN)) return -2;
            if (h->eof) {
                // flush already sent; drain done
                return 0;
            }
            ret = av_read_frame(h->fmt, h->pkt);
            if (ret < 0) {
                h->eof = 1;
                avcodec_send_packet(h->dec, nullptr);
                continue;
            }
            if (h->pkt->stream_index == h->stream_index) {
                avcodec_send_packet(h->dec, h->pkt);
            }
            av_packet_unref(h->pkt);
        }
    }
    AVFrame* f = h->frame;
    // Mid-stream reconfiguration: geometry OR pixel format/depth change
    // means the caller's buffers no longer fit.  Adopt the new format,
    // stash the frame, and return -3; the caller re-reads tm_info, resizes
    // its buffers, and the next call delivers this frame.
    if (!h->pending &&
        (f->width != h->cur_w || f->height != h->cur_h ||
         f->format != h->cur_fmt)) {
        h->cur_w = f->width;
        h->cur_h = f->height;
        h->cur_fmt = f->format;
        h->pending = 1;
        return -3;
    }
    h->pending = 0;
    if (pts) *pts = f->best_effort_timestamp;
    const AVPixFmtDescriptor* desc = av_pix_fmt_desc_get((AVPixelFormat)f->format);
    int bytes = desc->comp[0].depth > 8 ? 2 : 1;
    copy_plane(f->data[0], f->linesize[0], y, f->width, f->height, bytes);
    if (desc->nb_components >= 3) {
        int cw = AV_CEIL_RSHIFT(f->width, desc->log2_chroma_w);
        int ch = AV_CEIL_RSHIFT(f->height, desc->log2_chroma_h);
        copy_plane(f->data[1], f->linesize[1], u, cw, ch, bytes);
        copy_plane(f->data[2], f->linesize[2], v, cw, ch, bytes);
    }
    av_frame_unref(f);
    return 1;
}

void tm_close(TmHandle* h) {
    if (!h) return;
    tm_free(h);
}

// Seek to the keyframe at or before `ts` (stream time_base units) and flush
// the decoder.  The role of NVDEC's parser re-feeding for windowed runs:
// chunked multi-worker decode seeks each worker to its chunk start instead
// of decode-and-discard.  Returns 0 on success.
int tm_seek(TmHandle* h, int64_t ts) {
    if (!h) return -1;
    int ret = av_seek_frame(h->fmt, h->stream_index, ts, AVSEEK_FLAG_BACKWARD);
    if (ret < 0) return -2;
    avcodec_flush_buffers(h->dec);
    h->eof = 0;
    h->pending = 0;
    av_frame_unref(h->frame);
    return 0;
}

// Decoder availability probe (e.g. "h264", "av1", "mpeg2video").
int tm_has_decoder(const char* name) {
    return avcodec_find_decoder_by_name(name) != nullptr;
}

}  // extern "C"
