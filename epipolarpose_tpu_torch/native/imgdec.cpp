// imgdec: the native passes of the port's PNG and BMP readers, in
// standard C++17 with no library.
//
// PNG: the caller (data/png.py) walks the chunks, checks the CRCs and
// inflates the IDAT stream with Python's zlib; epk_png_unfilter takes the
// inflated scanlines and undoes the filters (types 0-4, Paeth as the PNG
// specification defines it), de-interlaces Adam7 and converts to 8-bit
// RGB as OpenCV's IMREAD_COLOR read through libpng does: 16-bit
// samples give their high byte (png_set_strip_16), grey samples of 1, 2
// and 4 bits are scaled to 8 and copied into the three channels, palette
// indices look up a 256-entry table whose entries past PLTE are black,
// and alpha is dropped, not composited.
//
// BMP: epk_bmp_rle decodes RLE8 and RLE4 data into palette indices as
// OpenCV 5's grfmt_bmp.cpp does. A run that would pass the end of its
// line, and data that ends before the bitmap is whole, fail the decode
// (OpenCV then gives no image). The escapes fill the pixels they skip
// with index 0, wrapping to the next lines: in RLE8, end of line fills
// the rest of the line (and is ignored right after a run that ended its
// line, which moves to the next line itself), end of bitmap the rest of
// the bitmap, delta (dx, dy) dx + dy * width pixels; in RLE4, whose runs
// never move to the next line, end of line and end of bitmap both fill
// the rest of the line, and delta fills dx pixels (dy is read and
// ignored).
//
// TIFF: the strip and tile codecs of libtiff 4.7 that the port's TIFF
// reader (data/tiff.py) does not leave to Python's zlib, each decoding
// as libtiff decodes it, damaged data included: epk_tiff_lzw is
// tif_lzw.c's LZWDecode (MSB-first codes of 9-12 bits, the code width
// growing one code early, CLEAR and EOI; data that ends before EOI reads
// as ending there; a code past the table, a string of no length or a
// first code that follows no CLEAR fails the strip), epk_tiff_packbits
// tif_packbits.c's PackBitsDecode. Each fills ``out`` (``occ`` bytes)
// and stops there; a strip whose data fails or runs out first fails,
// with the bytes decoded before that left in ``out`` and ``*written``
// saying how many (libtiff's reader then shows the strip as it stands:
// the caller's zeros past them, no predictor undone, no bytes swapped).
// epk_tiff_unpredict undoes the horizontal predictor (Predictor 2) of
// 8- and 16-bit samples row by row, as tif_predict.c's horAcc8 and
// horAcc16 (after swabbing a file of the other byte order) do.
//
// C interface (status 0 ok, 1 corrupt data, 3 bad arguments; ``err``
// receives the message):
//   int epk_png_unfilter(data, n, width, height, depth, color_type,
//                        interlace, palette, out, err, errlen)
//     data: the inflated scanlines, at least as many bytes as the image
//     needs; palette: 256 RGB entries; out: height x width x 3 bytes.
//   int epk_bmp_rle(data, n, width, height, bits, out, err, errlen)
//     data: the RLE stream from the pixel offset on; bits 8 or 4; out:
//     height x width palette indices, the file's first row (the bottom
//     one of a bottom-up file) first.
//   int epk_tiff_lzw(data, n, out, occ, written)
//   int epk_tiff_packbits(data, n, out, occ, written)
//     status 0: ``out`` full; 1: the strip fails (``*written`` bytes
//     decoded); epk_tiff_lzw 2: old-style (LSB-first) LZW, not decoded.
//   int epk_tiff_unpredict(buf, rows, row_samples, stride, bytes, swap)
//     buf: rows of row_samples samples of ``bytes`` (1 or 2) bytes each;
//     each sample adds the one ``stride`` samples before it in its row;
//     ``swap``: 16-bit samples in the other byte order, swabbed first.
// Thread-safe: no mutable global state. The calls run without the
// interpreter lock (ctypes), so the loader's threads decode in parallel.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                          {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                          {0, 1, 1, 2}};

int fail(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg);
  return 1;
}

// The Paeth predictor, without branches: pa, pb, pc are |p - a|, |p - b|,
// |p - c| for p = a + b - c; ties go to a, then b.
inline uint8_t paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c);
  const int pc = std::abs(a + b - 2 * c);
  const int bc = pb <= pc ? b : c;
  return static_cast<uint8_t>(pa <= std::min(pb, pc) ? a : bc);
}

// Undo filter ``type`` on ``row`` (n bytes) given the unfiltered previous
// row ``prev`` (zeros for a pass's first row); false for a bad type.
bool unfilter(int type, uint8_t* row, const uint8_t* prev, size_t n,
              size_t bpp) {
  switch (type) {
    case 0:
      return true;
    case 1:
      for (size_t i = bpp; i < n; ++i) row[i] += row[i - bpp];
      return true;
    case 2:
      for (size_t i = 0; i < n; ++i) row[i] += prev[i];
      return true;
    case 3:
      for (size_t i = 0; i < bpp && i < n; ++i) row[i] += prev[i] >> 1;
      for (size_t i = bpp; i < n; ++i)
        row[i] += static_cast<uint8_t>((row[i - bpp] + prev[i]) >> 1);
      return true;
    case 4:
      for (size_t i = 0; i < bpp && i < n; ++i) row[i] += prev[i];
      if (bpp == 3 || bpp == 4) {       // a pixel a step: its lanes overlap
        for (size_t i = bpp; i + bpp <= n; i += bpp)
          for (size_t k = 0; k < 4; ++k)
            if (k < bpp)
              row[i + k] += paeth(row[i + k - bpp], prev[i + k],
                                  prev[i + k - bpp]);
        return true;
      }
      for (size_t i = bpp; i < n; ++i)
        row[i] += paeth(row[i - bpp], prev[i], prev[i - bpp]);
      return true;
    default:
      return false;
  }
}

struct Format {
  int depth, color_type, channels;
  const uint8_t* palette;  // 256 x RGB
};

// One unfiltered row of ``count`` pixels -> RGB at out, out + step, ...
void convert(const Format& f, const uint8_t* row, int count, uint8_t* out,
             size_t step) {
  if (f.depth < 8) {
    const int mask = (1 << f.depth) - 1, scale = 255 / mask;
    for (int x = 0; x < count; ++x, out += step) {
      const int pos = x * f.depth;
      const int v = (row[pos >> 3] >> (8 - f.depth - (pos & 7))) & mask;
      if (f.color_type == 3) {
        const uint8_t* p = f.palette + 3 * v;
        out[0] = p[0], out[1] = p[1], out[2] = p[2];
      } else {
        out[0] = out[1] = out[2] = static_cast<uint8_t>(v * scale);
      }
    }
    return;
  }
  const int bytes = f.depth / 8;            // the high byte comes first
  const size_t stride = static_cast<size_t>(f.channels) * bytes;
  for (int x = 0; x < count; ++x, out += step, row += stride) {
    if (f.color_type == 3) {
      const uint8_t* p = f.palette + 3 * row[0];
      out[0] = p[0], out[1] = p[1], out[2] = p[2];
    } else if (f.color_type == 0 || f.color_type == 4) {
      out[0] = out[1] = out[2] = row[0];
    } else {
      out[0] = row[0], out[1] = row[bytes], out[2] = row[2 * bytes];
    }
  }
}

// ------------------------------------------------------------ TIFF LZW
constexpr int kLzwClear = 256, kLzwEoi = 257, kLzwFirst = 258;
constexpr int kLzwBitsMax = 12;
// tif_lzw.c's CSIZE: the table holds MAXCODE(BITS_MAX) + 1024 entries
constexpr int kLzwTable = (1 << kLzwBitsMax) - 1 + 1024;

// An entry's string is where the decoder wrote it first: the previous
// code's string followed by one byte, in the output already (each entry
// is its prefix's string plus the next code's first byte, and those lie
// side by side in the output), so a code is copied from there rather
// than walked back through its prefixes.
struct LzwEntry {
  uint32_t pos;         // the string's first byte in the output
  uint16_t length;      // 0: not yet defined
  uint8_t firstchar;
};

// tif_lzw.c LZWDecode (libtiff 4.7): 0 when ``occ`` bytes were decoded,
// 1 when the strip fails first
int lzw_decode(const uint8_t* in, size_t n, uint8_t* out, size_t occ,
               size_t* written) {
  if (occ > UINT32_MAX) return 1;
  std::vector<LzwEntry> tab(kLzwTable, LzwEntry{0, 0, 0});
  for (int c = 0; c < 256; ++c)
    tab[c] = {0, 1, static_cast<uint8_t>(c)};
  const size_t total = occ;
  size_t w = 0;                // bytes written
  uint64_t bitsleft = static_cast<uint64_t>(n) * 8;
  uint64_t acc = 0;
  int accbits = 0, nbits = 9;
  int nbitsmask = (1 << 9) - 1, maxcode = nbitsmask - 1;
  int free_ent = -1;    // before the first CLEAR no entry may be added
  int oldcode = 0;
  size_t last_pos = 0, last_len = 0;   // the previous code's string
  size_t pos = 0;
  auto next_code = [&]() -> int {
    if (bitsleft < static_cast<uint64_t>(nbits)) return kLzwEoi;
    while (accbits < nbits) {
      acc = (acc << 8) | in[pos++];
      accbits += 8;
    }
    const int code = static_cast<int>((acc >> (accbits - nbits)) & nbitsmask);
    accbits -= nbits;
    bitsleft -= nbits;
    return code;
  };
  int status = 0;
  while (w < total) {
    int code = next_code();
    if (code == kLzwEoi) break;
    if (code == kLzwClear) {
      do {
        free_ent = kLzwFirst;
        std::fill(tab.begin() + kLzwFirst, tab.end(), LzwEntry{0, 0, 0});
        nbits = 9;
        nbitsmask = (1 << 9) - 1;
        maxcode = nbitsmask - 1;
        code = next_code();
      } while (code == kLzwClear);
      if (code == kLzwEoi) break;
      if (code > kLzwEoi) { status = 1; break; }       // corrupted table
      last_pos = w;
      last_len = 1;
      out[w++] = static_cast<uint8_t>(code);
      oldcode = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kLzwTable) { status = 1; break; }
    tab[free_ent] = {static_cast<uint32_t>(last_pos),
                     static_cast<uint16_t>(last_len + 1),
                     tab[oldcode].firstchar};
    if (++free_ent > maxcode) {
      nbits = std::min(nbits + 1, kLzwBitsMax);
      nbitsmask = (1 << nbits) - 1;
      maxcode = nbitsmask - 1;
    }
    oldcode = code;
    if (code < 256) {
      last_pos = w;
      last_len = 1;
      out[w++] = static_cast<uint8_t>(code);
      continue;
    }
    const size_t len = tab[code].length;
    if (len == 0) { status = 1; break; }      // wrong length of string
    // a string longer than the room left fills it with its first bytes
    const size_t k = std::min(len, total - w);
    const uint8_t* src = out + tab[code].pos;
    uint8_t* dst = out + w;
    if (src + k <= dst)
      std::memcpy(dst, src, k);
    else
      for (size_t i = 0; i < k; ++i) dst[i] = src[i];   // KwKwK overlap
    last_pos = w;
    last_len = len;
    w += k;
  }
  *written = w;
  if (status == 0 && w < total) status = 1;   // not enough data
  return status;
}

}  // namespace

extern "C" {

int epk_png_unfilter(const uint8_t* data, size_t n, int width, int height,
                     int depth, int color_type, int interlace,
                     const uint8_t* palette, uint8_t* out, char* err,
                     int errlen) {
  static const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};
  if (width <= 0 || height <= 0 || color_type < 0 || color_type > 6 ||
      kChannels[color_type] == 0 ||
      (depth != 1 && depth != 2 && depth != 4 && depth != 8 && depth != 16))
    return 3;
  const Format f{depth, color_type, kChannels[color_type], palette};
  const size_t bits = static_cast<size_t>(f.channels) * depth;
  const size_t bpp = bits < 8 ? 1 : bits / 8;
  const size_t line = static_cast<size_t>(width) * 3;
  const size_t row_bytes = (static_cast<size_t>(width) * bits + 7) / 8;
  std::vector<uint8_t> rows(2 * row_bytes);
  size_t pos = 0;
  const int passes = interlace ? 7 : 1;
  for (int p = 0; p < passes; ++p) {
    const int x0 = interlace ? kAdam7[p][0] : 0;
    const int y0 = interlace ? kAdam7[p][1] : 0;
    const int dx = interlace ? kAdam7[p][2] : 1;
    const int dy = interlace ? kAdam7[p][3] : 1;
    if (x0 >= width || y0 >= height) continue;       // an empty pass
    const int pw = (width - x0 + dx - 1) / dx;
    const size_t nbytes = (static_cast<size_t>(pw) * bits + 7) / 8;
    uint8_t* cur = rows.data();
    uint8_t* prev = rows.data() + row_bytes;
    std::memset(prev, 0, nbytes);
    for (int y = y0; y < height; y += dy) {
      if (n - pos < nbytes + 1) return 3;
      std::memcpy(cur, data + pos + 1, nbytes);
      if (!unfilter(data[pos], cur, prev, nbytes, bpp))
        return fail(err, errlen, "bad adaptive filter value");
      pos += nbytes + 1;
      convert(f, cur, pw,
              out + static_cast<size_t>(y) * line + static_cast<size_t>(x0) * 3,
              static_cast<size_t>(dx) * 3);
      std::swap(cur, prev);
    }
  }
  return 0;
}

int epk_bmp_rle(const uint8_t* data, size_t n, int width, int height,
                int bits, uint8_t* out, char* err, int errlen) {
  if (width <= 0 || height <= 0 || (bits != 4 && bits != 8)) return 3;
  const size_t w = static_cast<size_t>(width);
  size_t pos = 0, x = 0;
  int y = 0;
  // utils.cpp's FillUniColor: ``count`` pixels of ``value``, wrapping to
  // the next line, which it also enters when it ends on the line's end
  auto fill = [&](size_t count, uint8_t value) {
    do {
      const size_t k = std::min(count, w - x);
      std::memset(out + static_cast<size_t>(y) * w + x, value, k);
      x += k, count -= k;
      if (x >= w) {
        x = 0;
        if (++y >= height) break;
      }
    } while (count > 0);
  };
  bool line_end_flag = false;  // RLE8: the last run ended its line
  while (y < height) {
    if (n - pos < 2)
      return fail(err, errlen, "RLE data ends early");
    const size_t len = data[pos];
    const int code = data[pos + 1];
    pos += 2;
    uint8_t* row = out + static_cast<size_t>(y) * w;
    if (len != 0) {                                   // encoded run
      if (x + len > w) return fail(err, errlen, "RLE run passes its line");
      if (bits == 8) {
        const int y0 = y;
        fill(len, static_cast<uint8_t>(code));
        line_end_flag = y != y0;
      } else {                                        // no wrap in RLE4
        for (size_t i = 0; i < len; ++i)
          row[x + i] = (i & 1) ? (code & 15) : (code >> 4);
        x += len;
      }
    } else if (code > 2) {                            // absolute run
      const size_t count = static_cast<size_t>(code);
      if (x + count > w) return fail(err, errlen, "RLE run passes its line");
      const size_t sz = bits == 8 ? ((count + 1) & ~size_t(1))
                                  : ((((count + 1) >> 1) + 1) & ~size_t(1));
      if (n - pos < sz) return fail(err, errlen, "RLE data ends early");
      for (size_t i = 0; i < count; ++i)
        row[x + i] = bits == 8 ? data[pos + i]
                               : ((i & 1) ? (data[pos + i / 2] & 15)
                                          : (data[pos + i / 2] >> 4));
      pos += sz;
      x += count;
      line_end_flag = false;
    } else if (bits == 8) {         // RLE8: end of line, bitmap, delta
      if (code != 0 || !line_end_flag || x != 0) {
        size_t skip = w - x + (code == 1 ? (height - y) * w : 0);
        if (code == 2) {
          if (n - pos < 2) return fail(err, errlen, "RLE data ends early");
          skip = data[pos] + static_cast<size_t>(data[pos + 1]) * w;
          pos += 2;
        }
        fill(skip, 0);
      }
      line_end_flag = false;
    } else {                        // RLE4: end of bitmap acts as end of
      size_t skip = w - x;          // line, and a delta skips dx only
      if (code == 2) {
        if (n - pos < 2) return fail(err, errlen, "RLE data ends early");
        skip = data[pos];
        pos += 2;
      }
      fill(skip, 0);
    }
  }
  return 0;
}

int epk_tiff_lzw(const uint8_t* data, size_t n, uint8_t* out, size_t occ,
                 size_t* written) {
  *written = 0;
  // tif_lzw.c LZWPreDecode: the old, LSB-first coding
  if (n >= 2 && data[0] == 0 && (data[1] & 1)) return 2;
  return lzw_decode(data, n, out, occ, written);
}

// tif_packbits.c PackBitsDecode
int epk_tiff_packbits(const uint8_t* data, size_t n, uint8_t* out,
                      size_t occ, size_t* written) {
  uint8_t* const out0 = out;
  size_t cc = n;
  const uint8_t* bp = data;
  while (cc > 0 && occ > 0) {
    long count = static_cast<int8_t>(*bp++);
    --cc;
    if (count < 0) {                 // the next byte, 1 - count times
      if (count == -128) continue;
      count = -count + 1;
      if (occ < static_cast<size_t>(count)) count = static_cast<long>(occ);
      if (cc == 0) break;
      occ -= count;
      const uint8_t b = *bp++;
      --cc;
      std::memset(out, b, count);
      out += count;
    } else {                         // count + 1 bytes as they stand
      if (occ < static_cast<size_t>(count + 1))
        count = static_cast<long>(occ) - 1;
      if (cc < static_cast<size_t>(count + 1)) break;
      ++count;
      std::memcpy(out, bp, count);
      out += count;
      occ -= count;
      bp += count;
      cc -= count;
    }
  }
  *written = static_cast<size_t>(out - out0);
  return occ > 0 ? 1 : 0;
}

int epk_tiff_unpredict(uint8_t* buf, size_t rows, size_t row_samples,
                       int stride, int bytes, int swap) {
  if (stride < 1 || (bytes != 1 && bytes != 2)) return 3;
  const size_t st = static_cast<size_t>(stride);
  if (bytes == 1) {
    for (size_t y = 0; y < rows; ++y) {
      uint8_t* r = buf + y * row_samples;
      for (size_t i = st; i < row_samples; ++i) r[i] += r[i - st];
    }
    return 0;
  }
  for (size_t y = 0; y < rows; ++y) {
    uint8_t* r = buf + 2 * y * row_samples;
    if (swap)
      for (size_t i = 0; i < row_samples; ++i) std::swap(r[2 * i], r[2 * i + 1]);
    uint16_t* w = reinterpret_cast<uint16_t*>(r);
    for (size_t i = st; i < row_samples; ++i)
      w[i] = static_cast<uint16_t>(w[i] + w[i - st]);
  }
  return 0;
}

}  // extern "C"
