// ANSI byte-grammar emitter: walks fixed-shape device "cell records" and
// produces byte-exact terminal frames, batched + multithreaded.
//
// This is the framework's host-side counterpart of the reference's scalar
// emission loops (lib/video/ascii/scalar/*.c, output_buffer.c, terminal/ansi.c):
// the per-pixel math already happened on-device (asciichat_tpu/ops), so each
// function here is a pure table walk over uint8 arrays — decimal LUTs, cached
// SGR prefixes, REP profitability, and the per-renderer run/state rules.
//
// Grammar ground truth (reference file:line):
//   SGR fg/bg/reset/REP     output_buffer.c:107-164
//   REP profitability       output_buffer.c:148-154 (run>2 && run-1 > digits+3)
//   truecolor RLE ctx       terminal/ansi.c:248-314
//   256/16-color quantizers terminal/ansi.c:360-477
//   Floyd-Steinberg         terminal/ansi.c:511-583 (C truncating division)
//   halfblock state machine scalar/halfblock.c
//   width/height padding    ascii.c:457-517, 902-941
//
// Build: g++ -O3 -march=native -shared -fPIC -o libac_emitter.so emitter.cpp

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct Dec3 {
  uint8_t len;
  char s[3];
};

Dec3 DEC3[256];
// ";<dec>" stamped as ONE unaligned 4-byte store (over-write, advance by
// SEMI_L): the hot-path replacement for put1(';') + put_dec(v).
uint32_t SEMI_W[256];
uint8_t SEMI_L[256];
// 16-color SGR code strings: fg 30-37/90-97, bg 40-47/100-107 (ansi.c:386-394)
char FG16[16][8];
uint8_t FG16_LEN[16];
char BG16[16][8];
uint8_t BG16_LEN[16];

struct InitTables {
  InitTables() {
    for (int v = 0; v < 256; ++v) {
      int d2 = v / 100, r = v - d2 * 100, d1 = r / 10, d0 = r - d1 * 10;
      if (d2) {
        DEC3[v].len = 3;
        DEC3[v].s[0] = char('0' + d2);
        DEC3[v].s[1] = char('0' + d1);
        DEC3[v].s[2] = char('0' + d0);
      } else if (d1) {
        DEC3[v].len = 2;
        DEC3[v].s[0] = char('0' + d1);
        DEC3[v].s[1] = char('0' + d0);
      } else {
        DEC3[v].len = 1;
        DEC3[v].s[0] = char('0' + d0);
      }
      char w[4] = {';', DEC3[v].s[0], DEC3[v].s[1], DEC3[v].s[2]};
      memcpy(&SEMI_W[v], w, 4);
      SEMI_L[v] = (uint8_t)(1 + DEC3[v].len);
    }
    for (int i = 0; i < 16; ++i) {
      int fg = i < 8 ? 30 + i : 90 + (i - 8);
      int bg = i < 8 ? 40 + i : 100 + (i - 8);
      FG16_LEN[i] = (uint8_t)snprintf(FG16[i], sizeof(FG16[i]), "\x1b[%dm", fg);
      BG16_LEN[i] = (uint8_t)snprintf(BG16[i], sizeof(BG16[i]), "\x1b[%dm", bg);
    }
  }
};
InitTables g_init;

struct Buf {
  uint8_t* p;
};

inline void put(Buf& b, const void* s, size_t n) {
  memcpy(b.p, s, n);
  b.p += n;
}
inline void put1(Buf& b, char c) { *b.p++ = (uint8_t)c; }
inline void put_dec(Buf& b, uint8_t v) { put(b, DEC3[v].s, DEC3[v].len); }
inline void put_u32(Buf& b, uint32_t v) {
  char tmp[10];
  int i = 0;
  do {
    tmp[i++] = char('0' + v % 10u);
    v /= 10u;
  } while (v);
  while (i--) put1(b, tmp[i]);
}

// SGR stamping: fixed 6/8-byte prefix stores + one 4-byte ";ddd" store per
// component (over-write; advance by actual length). ~6 unaligned stores per
// truecolor SGR instead of ~12 byte-wise puts — the buffer always has slack
// (worst-case stride sizing in render/emitter.py).
inline void sgr_tc(Buf& b, const char* prefix6, uint8_t r, uint8_t g,
                   uint8_t bl) {
  memcpy(b.p, prefix6, 6);
  b.p += 6;
  memcpy(b.p, &SEMI_W[r], 4);
  b.p += SEMI_L[r];
  memcpy(b.p, &SEMI_W[g], 4);
  b.p += SEMI_L[g];
  memcpy(b.p, &SEMI_W[bl], 4);
  b.p += SEMI_L[bl];
  *b.p++ = 'm';
}
inline void sgr_tc_fg(Buf& b, uint8_t r, uint8_t g, uint8_t bl) {
  sgr_tc(b, "\x1b[38;2", r, g, bl);
}
inline void sgr_tc_bg(Buf& b, uint8_t r, uint8_t g, uint8_t bl) {
  sgr_tc(b, "\x1b[48;2", r, g, bl);
}
inline void sgr_256(Buf& b, const char* prefix6, uint8_t idx) {
  memcpy(b.p, prefix6, 6);
  b.p += 6;
  memcpy(b.p, &SEMI_W[idx], 4);
  b.p += SEMI_L[idx];
  *b.p++ = 'm';
}
inline void sgr_256_fg(Buf& b, uint8_t idx) { sgr_256(b, "\x1b[38;5", idx); }
inline void sgr_256_bg(Buf& b, uint8_t idx) { sgr_256(b, "\x1b[48;5", idx); }
inline void sgr_16_fg(Buf& b, uint8_t idx) {
  if (idx >= 16) idx = 7;
  put(b, FG16[idx], FG16_LEN[idx]);
}
inline void sgr_16_bg(Buf& b, uint8_t idx) {
  if (idx >= 16) idx = 0;
  put(b, BG16[idx], BG16_LEN[idx]);
}
inline void sgr_reset(Buf& b) { put(b, "\x1b[0m", 4); }

inline int digits_u32(uint32_t v) {
  int d = 1;
  while (v >= 10u) {
    v /= 10u;
    ++d;
  }
  return d;
}
inline bool rep_profitable(uint32_t run) {
  if (run <= 2) return false;
  uint32_t k = run - 1;
  return k > (uint32_t)(digits_u32(k) + 3);
}
inline void emit_rep(Buf& b, uint32_t extra) {
  put(b, "\x1b[", 2);
  put_u32(b, extra);
  put1(b, 'b');
}
inline void pad_spaces(Buf& b, int n) {
  memset(b.p, ' ', (size_t)n);
  b.p += n;
}
inline void pad_top(Buf& b, int n) {
  memset(b.p, '\n', (size_t)n);
  b.p += n;
}

// Quantizers (exact integer re-derivation of terminal/ansi.c:360-477)
inline uint8_t rgb_to_256(int r, int g, int b) {
  int avg = (r + g + b) / 3;
  int gd = abs(r - avg) + abs(g - avg) + abs(b - avg);
  if (gd < 30) return (uint8_t)(232 + (avg * 23) / 255);
  return (uint8_t)(16 + (r * 5 / 255) * 36 + (g * 5 / 255) * 6 + (b * 5 / 255));
}

const int ANSI16[16][3] = {
    {0, 0, 0},       {128, 0, 0},   {0, 128, 0},   {128, 128, 0},
    {0, 0, 128},     {128, 0, 128}, {0, 128, 128}, {192, 192, 192},
    {128, 128, 128}, {255, 0, 0},   {0, 255, 0},   {255, 255, 0},
    {0, 0, 255},     {255, 0, 255}, {0, 255, 255}, {255, 255, 255},
};

inline uint8_t rgb_to_16(int r, int g, int b) {
  int best = 0;
  int bd = INT32_MAX;
  for (int i = 0; i < 16; ++i) {
    int dr = r - ANSI16[i][0], dg = g - ANSI16[i][1], db = b - ANSI16[i][2];
    int d = dr * dr + dg * dg + db * db;
    if (d < bd) {
      bd = d;
      best = i;
    }
  }
  return (uint8_t)best;
}

inline int clamp_rgb(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// Glyph table entry: 5 bytes = {len, b0, b1, b2, b3}
inline void put_glyph(Buf& b, const uint8_t* tab, unsigned idx) {
  const uint8_t* e = tab + idx * 5;
  memcpy(b.p, e + 1, 4);  // over-copy, len<=4; advance by real len
  b.p += e[0];
}

// Run scanning 8 bytes at a time: returns the first index > x where row
// differs from row[x] (the end of the run). ~8x fewer compares on flat
// regions; the tail falls back to byte compares.
inline int run_end_u8(const uint8_t* row, int x, int W, uint8_t k) {
  uint64_t pat = 0x0101010101010101ull * k;
  int j = x + 1;
  while (j + 8 <= W) {
    uint64_t v;
    memcpy(&v, row + j, 8);
    uint64_t diff = v ^ pat;
    if (diff) return j + (int)(__builtin_ctzll(diff) >> 3);
    j += 8;
  }
  while (j < W && row[j] == k) ++j;
  return j;
}

// End of the run where BOTH halfblock rows' packed RGB stay constant;
// writes the packed colors at x. Shared by the truecolor and mono halfblock
// emitters so a run-rule fix cannot silently diverge between them.
inline int run_end_pair_rgb(const uint8_t* rt, const uint8_t* rb, int x,
                            int W, int& tcol, int& bcol) {
  tcol = rt[x * 3] << 16 | rt[x * 3 + 1] << 8 | rt[x * 3 + 2];
  bcol = rb[x * 3] << 16 | rb[x * 3 + 1] << 8 | rb[x * 3 + 2];
  int j = x + 1;
  while (j < W) {
    int t2 = rt[j * 3] << 16 | rt[j * 3 + 1] << 8 | rt[j * 3 + 2];
    int b2 = rb[j * 3] << 16 | rb[j * 3 + 1] << 8 | rb[j * 3 + 2];
    if (t2 != tcol || b2 != bcol) break;
    ++j;
  }
  return j;
}

// Returns false if any invocation threw (e.g. bad_alloc in a per-frame
// scratch vector). The barrier matters: an exception escaping a
// std::thread body calls std::terminate and kills the whole embedding
// process, and in the 1-thread path it would unwind across the
// extern "C"/ctypes boundary (undefined behavior). Callers mark lens[b]=-1
// so the Python wrapper can raise instead.
bool parallel_for(int B, int nthreads, const std::function<void(int)>& fn) {
  std::atomic<bool> ok{true};
  auto safe = [&](int b) {
    try {
      fn(b);
    } catch (...) {
      ok.store(false);
    }
  };
  if (nthreads <= 1 || B <= 1) {
    for (int b = 0; b < B && ok.load(); ++b) safe(b);
    return ok.load();
  }
  int T = std::min(nthreads, B);
  std::atomic<int> next{0};
  std::vector<std::thread> ts;
  ts.reserve((size_t)T);
  for (int t = 0; t < T; ++t)
    ts.emplace_back([&] {
      int b;
      while ((b = next.fetch_add(1)) < B && ok.load()) safe(b);
    });
  for (auto& t : ts) t.join();
  return ok.load();
}

}  // namespace

extern "C" {

// mono: image_print grammar (scalar/foreground.c:27-138). keys u8 [B,H,W];
// glyphs64 = uint8[64,5] indexed by run key. No SGR; REP; '\n' between rows.
void ac_emit_mono(const uint8_t* keys, int B, int H, int W,
                  const uint8_t* glyphs64, int pad_w, int pad_h, uint8_t* out,
                  int64_t stride, int64_t* lens, int nthreads) {
  bool ok_ = parallel_for(B, nthreads, [&](int b) {
    Buf buf{out + (int64_t)b * stride};
    const uint8_t* base = keys + (int64_t)b * H * W;
    pad_top(buf, pad_h);
    for (int y = 0; y < H; ++y) {
      const uint8_t* row = base + (int64_t)y * W;
      if (pad_w) pad_spaces(buf, pad_w);
      int x = 0;
      while (x < W) {
        uint8_t k = row[x];
        int j = run_end_u8(row, x, W, k);
        uint32_t run = (uint32_t)(j - x);
        put_glyph(buf, glyphs64, k);
        if (rep_profitable(run)) {
          emit_rep(buf, run - 1);
        } else {
          for (uint32_t i = 1; i < run; ++i) put_glyph(buf, glyphs64, k);
        }
        x = j;
      }
      if (y != H - 1) put1(buf, '\n');
    }
    lens[b] = buf.p - (out + (int64_t)b * stride);
  });
  if (!ok_)
    for (int b = 0; b < B; ++b) lens[b] = -1;
}

// truecolor FG: image_print_color grammar (foreground.c:195-308 + RLE ctx
// ansi.c:248-314). rgb u8 [B,H,W,3], luma u8 [B,H,W]; glyphs256 indexed by
// luma. SGR only on color change; multi-byte glyphs bypass RLE state; one
// trailing reset per frame.
void ac_emit_truecolor_fg(const uint8_t* rgb, const uint8_t* luma, int B, int H,
                          int W, const uint8_t* glyphs256, int pad_w, int pad_h,
                          uint8_t* out, int64_t stride, int64_t* lens,
                          int nthreads) {
  // Specialize for all-ASCII glyph tables (every stock palette): glyph
  // emission is a single store and the RLE context compare is one packed u32
  // compare — no per-pixel table-shape branch.
  bool all_ascii = true;
  char gl1[256];
  for (int i = 0; i < 256; ++i) {
    const uint8_t* e = glyphs256 + i * 5;
    if (e[0] != 1 || e[1] >= 128) {
      all_ascii = false;
      break;
    }
    gl1[i] = (char)e[1];
  }
  bool ok_ = parallel_for(B, nthreads, [&](int b) {
    Buf buf{out + (int64_t)b * stride};
    const uint8_t* prgb = rgb + (int64_t)b * H * W * 3;
    const uint8_t* plum = luma + (int64_t)b * H * W;
    pad_top(buf, pad_h);
    if (all_ascii) {
      // last > 0xFFFFFF means "no context yet": the first pixel always
      // differs, which is exactly ansi_rle_init's first_pixel semantics
      // (ansi.c:255-257 — lr=lg=lb=255 with a first_pixel flag).
      uint32_t last = 0x1000000u;
      for (int y = 0; y < H; ++y) {
        if (pad_w) pad_spaces(buf, pad_w);
        const uint8_t* rowp = prgb + (int64_t)y * W * 3;
        const uint8_t* rowl = plum + (int64_t)y * W;
        for (int x = 0; x < W; ++x) {
          const uint8_t* px = rowp + x * 3;
          uint32_t cur = (uint32_t)px[0] << 16 | (uint32_t)px[1] << 8 | px[2];
          if (cur != last) {
            sgr_tc_fg(buf, px[0], px[1], px[2]);
            last = cur;
          }
          *buf.p++ = (uint8_t)gl1[rowl[x]];
        }
        if (y != H - 1) put1(buf, '\n');
      }
    } else {
      bool first_pixel = true;
      uint8_t lr = 255, lg = 255, lb = 255;  // ansi_rle_init (ansi.c:255-257)
      for (int y = 0; y < H; ++y) {
        if (pad_w) pad_spaces(buf, pad_w);
        const uint8_t* rowp = prgb + (int64_t)y * W * 3;
        const uint8_t* rowl = plum + (int64_t)y * W;
        for (int x = 0; x < W; ++x) {
          uint8_t r = rowp[x * 3], g = rowp[x * 3 + 1], bl = rowp[x * 3 + 2];
          const uint8_t* e = glyphs256 + (unsigned)rowl[x] * 5;
          if (e[0] == 1 && e[1] < 128) {
            if (first_pixel || r != lr || g != lg || bl != lb) {
              sgr_tc_fg(buf, r, g, bl);
              lr = r;
              lg = g;
              lb = bl;
              first_pixel = false;
            }
            put1(buf, (char)e[1]);
          } else {
            // multi-byte UTF-8: always SGR, ctx untouched (foreground.c:286-296)
            sgr_tc_fg(buf, r, g, bl);
            memcpy(buf.p, e + 1, 4);
            buf.p += e[0];
          }
        }
        if (y != H - 1) put1(buf, '\n');
      }
    }
    sgr_reset(buf);
    lens[b] = buf.p - (out + (int64_t)b * stride);
  });
  if (!ok_)
    for (int b = 0; b < B; ++b) lens[b] = -1;
}

// 256/16-color FG: SGR every pixel + glyph + reset per row (foreground.c:433-624).
// color u8 [B,H,W]; gidx u8 [B,H,W] is the glyph index into glyphs256
// (= luma for 256color, = palette run key for 16color). is16 selects SGR form.
void ac_emit_indexed(const uint8_t* color, const uint8_t* gidx, int B, int H,
                     int W, int is16, const uint8_t* glyphs256, int pad_w,
                     int pad_h, uint8_t* out, int64_t stride, int64_t* lens,
                     int nthreads) {
  bool ok_ = parallel_for(B, nthreads, [&](int b) {
    Buf buf{out + (int64_t)b * stride};
    const uint8_t* pc = color + (int64_t)b * H * W;
    const uint8_t* pg = gidx + (int64_t)b * H * W;
    pad_top(buf, pad_h);
    for (int y = 0; y < H; ++y) {
      if (pad_w) pad_spaces(buf, pad_w);
      const uint8_t* rc = pc + (int64_t)y * W;
      const uint8_t* rg = pg + (int64_t)y * W;
      for (int x = 0; x < W; ++x) {
        if (is16)
          sgr_16_fg(buf, rc[x]);
        else
          sgr_256_fg(buf, rc[x]);
        put_glyph(buf, glyphs256, rg[x]);
      }
      sgr_reset(buf);
      if (y < H - 1) put1(buf, '\n');
    }
    lens[b] = buf.p - (out + (int64_t)b * stride);
  });
  if (!ok_)
    for (int b = 0; b < B; ++b) lens[b] = -1;
}

// 16-color Floyd-Steinberg dithered (+ optional background mode): dither is
// raster-sequential (ansi.c:511-583) so it runs here on the host from resized
// RGB. use_background selects image_print_16color_dithered_with_background
// (foreground.c:752-846, glyph by luma) vs plain dithered (foreground.c:650-749,
// glyph by palette key ramp64[luma>>2]).
void ac_emit_16_dithered(const uint8_t* rgb, const uint8_t* luma, int B, int H,
                         int W, int use_background, const uint8_t* ramp64,
                         const uint8_t* glyphs256, int pad_w, int pad_h,
                         uint8_t* out, int64_t stride, int64_t* lens,
                         int nthreads) {
  bool ok_ = parallel_for(B, nthreads, [&](int b) {
    Buf buf{out + (int64_t)b * stride};
    const uint8_t* prgb = rgb + (int64_t)b * H * W * 3;
    const uint8_t* plum = luma + (int64_t)b * H * W;
    std::vector<int32_t> err((size_t)H * W * 3, 0);
    pad_top(buf, pad_h);
    for (int y = 0; y < H; ++y) {
      if (pad_w) pad_spaces(buf, pad_w);
      for (int x = 0; x < W; ++x) {
        size_t pi = (size_t)y * W + x;
        int r = prgb[pi * 3] + err[pi * 3];
        int g = prgb[pi * 3 + 1] + err[pi * 3 + 1];
        int bl = prgb[pi * 3 + 2] + err[pi * 3 + 2];
        uint8_t idx = rgb_to_16(clamp_rgb(r), clamp_rgb(g), clamp_rgb(bl));
        int er = r - ANSI16[idx][0];
        int eg = g - ANSI16[idx][1];
        int eb = bl - ANSI16[idx][2];
        // C integer division truncates toward zero — matches (e*k)/16.
        if (x + 1 < W) {
          size_t q = pi + 1;
          err[q * 3] += (er * 7) / 16;
          err[q * 3 + 1] += (eg * 7) / 16;
          err[q * 3 + 2] += (eb * 7) / 16;
        }
        if (y + 1 < H) {
          if (x - 1 >= 0) {
            size_t q = pi + W - 1;
            err[q * 3] += (er * 3) / 16;
            err[q * 3 + 1] += (eg * 3) / 16;
            err[q * 3 + 2] += (eb * 3) / 16;
          }
          size_t q = pi + W;
          err[q * 3] += (er * 5) / 16;
          err[q * 3 + 1] += (eg * 5) / 16;
          err[q * 3 + 2] += (eb * 5) / 16;
          if (x + 1 < W) {
            size_t q2 = pi + W + 1;
            err[q2 * 3] += (er * 1) / 16;
            err[q2 * 3 + 1] += (eg * 1) / 16;
            err[q2 * 3 + 2] += (eb * 1) / 16;
          }
        }
        uint8_t lum = plum[pi];
        if (use_background) {
          int br = ANSI16[idx][0], bg = ANSI16[idx][1], bb = ANSI16[idx][2];
          int bg_lum = (br * 77 + bg * 150 + bb * 29) / 256;  // no +128
          sgr_16_bg(buf, idx);
          sgr_16_fg(buf, bg_lum < 127 ? 15 : 0);
          put_glyph(buf, glyphs256, lum);
        } else {
          sgr_16_fg(buf, idx);
          put_glyph(buf, glyphs256, ramp64[lum >> 2]);
        }
      }
      sgr_reset(buf);
      if (y < H - 1) put1(buf, '\n');
    }
    lens[b] = buf.p - (out + (int64_t)b * stride);
  });
  if (!ok_)
    for (int b = 0; b < B; ++b) lens[b] = -1;
}

// Truecolor halfblock (halfblock.c:48-165). top/bot u8 [B,R,W,3] (bottom row
// already duplicated for odd heights on-device).
void ac_emit_halfblock_truecolor(const uint8_t* top, const uint8_t* bot, int B,
                                 int R, int W, int pad_w, int pad_h,
                                 uint8_t* out, int64_t stride, int64_t* lens,
                                 int nthreads) {
  bool ok_ = parallel_for(B, nthreads, [&](int b) {
    Buf buf{out + (int64_t)b * stride};
    const uint8_t* pt = top + (int64_t)b * R * W * 3;
    const uint8_t* pb = bot + (int64_t)b * R * W * 3;
    pad_top(buf, pad_h);
    for (int y = 0; y < R; ++y) {
      if (pad_w) pad_spaces(buf, pad_w);
      const uint8_t* rt = pt + (int64_t)y * W * 3;
      const uint8_t* rb = pb + (int64_t)y * W * 3;
      int cf = -1, cb = -1;  // packed current fg/bg (-1 = unset)
      int x = 0;
      while (x < W) {
        int tcol, bcol;
        int j = run_end_pair_rgb(rt, rb, x, W, tcol, bcol);
        uint32_t run = (uint32_t)(j - x);
        if (tcol == 0 && bcol == 0) {
          if (cf != -1 || cb != -1) {
            sgr_reset(buf);
            cf = cb = -1;
          }
          pad_spaces(buf, (int)run);
        } else {
          if (cf != tcol) {
            sgr_tc_fg(buf, (uint8_t)(tcol >> 16), (uint8_t)(tcol >> 8), (uint8_t)tcol);
            cf = tcol;
          }
          if (cb != bcol) {
            sgr_tc_bg(buf, (uint8_t)(bcol >> 16), (uint8_t)(bcol >> 8), (uint8_t)bcol);
            cb = bcol;
          }
          put(buf, "\xe2\x96\x80", 3);
          if (rep_profitable(run)) {
            emit_rep(buf, run - 1);
          } else {
            for (uint32_t i = 1; i < run; ++i) put(buf, "\xe2\x96\x80", 3);
          }
        }
        x = j;
      }
      sgr_reset(buf);
      if (y + 1 < R) put1(buf, '\n');
    }
    lens[b] = buf.p - (out + (int64_t)b * stride);
  });
  if (!ok_)
    for (int b = 0; b < B; ++b) lens[b] = -1;
}

// 16/256-color halfblock (halfblock.c:297-524): runs on quantized (fg,bg)
// pairs computed on-device; transparency flag from raw all-black RGB.
void ac_emit_halfblock_indexed(const uint8_t* fg, const uint8_t* bg,
                               const uint8_t* transparent, int B, int R, int W,
                               int is16, int pad_w, int pad_h, uint8_t* out,
                               int64_t stride, int64_t* lens, int nthreads) {
  bool ok_ = parallel_for(B, nthreads, [&](int b) {
    Buf buf{out + (int64_t)b * stride};
    const uint8_t* pf = fg + (int64_t)b * R * W;
    const uint8_t* pg = bg + (int64_t)b * R * W;
    const uint8_t* pt = transparent + (int64_t)b * R * W;
    pad_top(buf, pad_h);
    for (int y = 0; y < R; ++y) {
      if (pad_w) pad_spaces(buf, pad_w);
      const uint8_t* rf = pf + (int64_t)y * W;
      const uint8_t* rg = pg + (int64_t)y * W;
      const uint8_t* rt = pt + (int64_t)y * W;
      int cf = -1, cb = -1;
      int x = 0;
      while (x < W) {
        uint8_t f = rf[x], g = rg[x];
        // run ends where EITHER the fg or bg index changes
        int jf = run_end_u8(rf, x, W, f);
        int j = run_end_u8(rg, x, jf, g);
        uint32_t run = (uint32_t)(j - x);
        if (rt[x]) {
          if (cf != -1 || cb != -1) {
            sgr_reset(buf);
            cf = cb = -1;
          }
          pad_spaces(buf, (int)run);
        } else {
          if (cf != (int)f) {
            if (is16)
              sgr_16_fg(buf, f);
            else
              sgr_256_fg(buf, f);
            cf = f;
          }
          if (cb != (int)g) {
            if (is16)
              sgr_16_bg(buf, g);
            else
              sgr_256_bg(buf, g);
            cb = g;
          }
          put(buf, "\xe2\x96\x80", 3);
          if (rep_profitable(run)) {
            emit_rep(buf, run - 1);
          } else {
            for (uint32_t i = 1; i < run; ++i) put(buf, "\xe2\x96\x80", 3);
          }
        }
        x = j;
      }
      sgr_reset(buf);
      if (y + 1 < R) put1(buf, '\n');
    }
    lens[b] = buf.p - (out + (int64_t)b * stride);
  });
  if (!ok_)
    for (int b = 0; b < B; ++b) lens[b] = -1;
}

// Monochrome halfblock (halfblock.c:184-286): runs on exact RGB pair
// equality; luma weights 76/150/29 with no rounding; no SGR, no reset.
void ac_emit_halfblock_mono(const uint8_t* top, const uint8_t* bot, int B,
                            int R, int W, int pad_w, int pad_h, uint8_t* out,
                            int64_t stride, int64_t* lens, int nthreads) {
  static const char* SHADES[4] = {"\xe2\x96\x91", "\xe2\x96\x92",
                                  "\xe2\x96\x93", "\xe2\x96\x88"};
  bool ok_ = parallel_for(B, nthreads, [&](int b) {
    Buf buf{out + (int64_t)b * stride};
    const uint8_t* pt = top + (int64_t)b * R * W * 3;
    const uint8_t* pb = bot + (int64_t)b * R * W * 3;
    pad_top(buf, pad_h);
    for (int y = 0; y < R; ++y) {
      if (pad_w) pad_spaces(buf, pad_w);
      const uint8_t* rt = pt + (int64_t)y * W * 3;
      const uint8_t* rb = pb + (int64_t)y * W * 3;
      int x = 0;
      while (x < W) {
        int tcol, bcol;
        int j = run_end_pair_rgb(rt, rb, x, W, tcol, bcol);
        uint32_t run = (uint32_t)(j - x);
        int lum_top = (rt[x * 3] * 76 + rt[x * 3 + 1] * 150 + rt[x * 3 + 2] * 29) >> 8;
        int lum_bot = (rb[x * 3] * 76 + rb[x * 3 + 1] * 150 + rb[x * 3 + 2] * 29) >> 8;
        if (lum_top < 16 && lum_bot < 16) {
          pad_spaces(buf, (int)run);
        } else {
          const char* shade = SHADES[lum_top >> 6];
          put(buf, shade, 3);
          if (rep_profitable(run)) {
            emit_rep(buf, run - 1);
          } else {
            for (uint32_t i = 1; i < run; ++i) put(buf, shade, 3);
          }
        }
        x = j;
      }
      if (y + 1 < R) put1(buf, '\n');
    }
    lens[b] = buf.p - (out + (int64_t)b * stride);
  });
  if (!ok_)
    for (int b = 0; b < B; ++b) lens[b] = -1;
}

}  // extern "C"
