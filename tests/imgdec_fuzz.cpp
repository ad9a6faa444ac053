// Mutation harness for the TIFF codecs of the port's native image pass,
// built by tests/test_torch_tiff.py with -fsanitize=address,undefined:
//
//   imgdec_fuzz <mutations per stream> <stream>...
//
// Each file holds one strip's data, the first byte naming its codec (5:
// LZW, 0x80: PackBits) and the next four the decoded size (little
// endian). Each stream is decoded as given and then with seeded mutations
// (bytes overwritten, or the stream truncated), into a buffer of the size
// or of a seeded other size, and the predictor is undone over what was
// decoded, as 8- and 16-bit samples. Every call must return a status
// without a memory or undefined-behaviour fault; prints "whole <strips
// decoded whole> short <strips failed or cut short>".
#include "imgdec.cpp"

#include <fstream>
#include <iterator>
#include <random>

int main(int argc, char** argv) {
    if (argc < 3) return 2;
    const int per_stream = std::atoi(argv[1]);
    std::mt19937 rng(4321);
    long whole = 0, cut = 0;
    for (int f = 2; f < argc; ++f) {
        std::ifstream in(argv[f], std::ios::binary);
        const std::vector<uint8_t> file((std::istreambuf_iterator<char>(in)),
                                        {});
        if (file.size() < 6) return 2;
        const int codec = file[0];
        const size_t size = file[1] | (file[2] << 8) | (file[3] << 16) |
                            (static_cast<size_t>(file[4]) << 24);
        const std::vector<uint8_t> data(file.begin() + 5, file.end());
        for (int it = 0; it <= per_stream; ++it) {
            std::vector<uint8_t> m = data;
            if (it % 4 == 3) {
                m.resize(rng() % (m.size() + 1));
            } else if (it > 0) {
                const int n = 1 + rng() % 8;
                for (int k = 0; k < n && !m.empty(); ++k)
                    m[rng() % m.size()] = static_cast<uint8_t>(rng());
            }
            const size_t occ = it % 5 == 4 ? rng() % (2 * size + 1) : size;
            std::vector<uint8_t> out(occ + 1);
            size_t written = 0;
            const int status =
                codec == 5 ? epk_tiff_lzw(m.data(), m.size(), out.data(), occ,
                                          &written)
                           : epk_tiff_packbits(m.data(), m.size(), out.data(),
                                               occ, &written);
            if (written > occ) return 3;
            if (status == 0) ++whole; else ++cut;
            const size_t row = 1 + rng() % 64;
            epk_tiff_unpredict(out.data(), occ / row, row, 1 + it % 4, 1, 0);
            epk_tiff_unpredict(out.data(), occ / (2 * row), row, 1 + it % 3,
                               2, it % 2);
        }
    }
    std::printf("whole %ld short %ld\n", whole, cut);
    return 0;
}
