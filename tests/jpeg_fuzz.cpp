// Mutation harness for the port's JPEG decoder, built by
// tests/test_torch_jpeg.py with -fsanitize=address,undefined:
//
//   jpeg_fuzz <mutations per file> <file.jpg>...
//
// Each file is decoded as given and then with seeded mutations (bytes
// overwritten in the headers or anywhere, or the file truncated). Every
// call must return a status without a memory or undefined-behaviour
// fault; prints "ok <decoded> refused <errors>".
#include "jpegdec.cpp"

#include <fstream>
#include <iterator>
#include <random>

int main(int argc, char** argv) {
    if (argc < 3) return 2;
    const int per_file = std::atoi(argv[1]);
    std::mt19937 rng(1234);
    long ok = 0, refused = 0;
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
            if (epk_jpeg_info(m.data(), m.size(), &w, &h, &c, err, 256)) {
                ++refused;
                continue;
            }
            if (int64_t(w) * h > 50'000'000) {   // a mutated size: skip
                ++refused;
                continue;
            }
            std::vector<uint8_t> out(size_t(w) * h * 3);
            if (epk_jpeg_decode_rgb(m.data(), m.size(), out.data(), w, h,
                                    err, 256))
                ++refused;
            else
                ++ok;
        }
    }
    std::printf("ok %ld refused %ld\n", ok, refused);
    return 0;
}
