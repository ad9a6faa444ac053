// Mutation harness for the port's JPEG decoder, built by
// tests/test_torch_jpeg.py with -fsanitize=address,undefined:
//
//   jpeg_fuzz <mutations per file> <file.jpg>...
//
// Each file is decoded as given and then with seeded mutations (bytes
// overwritten in the headers or anywhere, or the file truncated), at full
// size and again at a DCT scale of 1/8 to 4/8, the flavours (libjpeg's,
// OpenCV's and the two of TIFF strips) in turn; lossless files decode in
// the OpenCV flavours, at full size only. Every call must return a status without a
// memory or undefined-behaviour fault; prints "ok <decoded> refused
// <errors> scaled <decoded at the scale>", a decode with a libjpeg warning
// (status 4 or 5: a truncated file) counted as decoded.
#include "jpegdec.cpp"

#include <fstream>
#include <iterator>
#include <random>

namespace {
bool decoded(int status) { return status == 0 || status == 4 || status == 5; }
}  // namespace

int main(int argc, char** argv) {
    if (argc < 3) return 2;
    const int per_file = std::atoi(argv[1]);
    std::mt19937 rng(1234);
    long ok = 0, refused = 0, scaled = 0;
    for (int f = 2; f < argc; ++f) {
        std::ifstream in(argv[f], std::ios::binary);
        const std::vector<uint8_t> file((std::istreambuf_iterator<char>(in)),
                                        {});
        if (file.empty()) return 2;
        for (int it = 0; it <= per_file; ++it) {
            std::vector<uint8_t> m = file;
            if (it % 4 == 3) {
                m.resize(rng() % m.size());
            } else if (it > 0) {
                const int n = 1 + rng() % 8;
                for (int k = 0; k < n; ++k) {
                    const size_t span =
                        it % 4 == 0 ? std::min<size_t>(m.size(), 700)
                                    : m.size();
                    m[rng() % span] = static_cast<uint8_t>(rng());
                }
            }
            int w = 0, h = 0, c = 0;
            char err[256];
            const int flavour = it % 4;
            if (epk_jpeg_info(m.data(), m.size(), 8, &w, &h, &c, flavour, err,
                              256)) {
                ++refused;
                continue;
            }
            if (int64_t(w) * h > 50'000'000) {   // a mutated size: skip
                ++refused;
                continue;
            }
            std::vector<uint8_t> out(size_t(w) * h * 3);
            if (decoded(epk_jpeg_decode_rgb(m.data(), m.size(), 8, out.data(),
                                            w, h, flavour, err, 256)))
                ++ok;
            else
                ++refused;
            const int s = 1 + it % 4;
            if (epk_jpeg_info(m.data(), m.size(), s, &w, &h, &c, flavour, err,
                              256))
                continue;
            std::vector<uint8_t> small(size_t(w) * h * 3);
            if (decoded(epk_jpeg_decode_rgb(m.data(), m.size(), s, small.data(),
                                            w, h, flavour, err, 256)))
                ++scaled;
        }
    }
    std::printf("ok %ld refused %ld scaled %ld\n", ok, refused, scaled);
    return 0;
}
