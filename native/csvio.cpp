// Native trajectory CSV writer — the framework's data-I/O runtime component.
//
// The reference's datagen bottleneck is a per-particle Python csv.DictWriter
// loop (reference src/s01-dataset-generation.py:218-241). This writes the
// same long-format table (schema at s01:108-125) from contiguous column
// arrays in one pass, with a fixed-size stack buffer per row and a large
// stdio buffer.
//
// C ABI (used from Python via ctypes, see nbody_sim/data/io_native.py):
//   nbody_write_csv(path, header,
//                   int_cols,   n_int,    // int64 columns, column-major
//                   str_idx, str_names, n_names,  // one string column (scene_type)
//                   dbl_cols,   n_dbl,    // double columns, column-major
//                   n_rows)
// Column order in the file: int_cols[0], str col, int_cols[1..], dbl_cols[..]
// which matches [scene, scene_type, step, step_time, mass, x..z, vx..vz,
// ax..az, u, k].

#include <cstdio>
#include <cstdint>
#include <cstring>
#include <cstdlib>

extern "C" {

int nbody_write_csv(const char* path,
                    const char* header,
                    const int64_t* int_cols, int n_int,
                    const int32_t* str_idx, const char** str_names, int n_names,
                    const double* dbl_cols, int n_dbl,
                    int64_t n_rows) {
    FILE* f = std::fopen(path, "w");
    if (!f) return -1;
    static const size_t BUF = 1 << 22;  // 4 MiB stdio buffer
    char* iobuf = (char*)std::malloc(BUF);
    if (iobuf) std::setvbuf(f, iobuf, _IOFBF, BUF);

    std::fputs(header, f);
    std::fputc('\n', f);

    char row[4096];
    for (int64_t r = 0; r < n_rows; ++r) {
        char* p = row;
        // first int column (scene)
        p += std::snprintf(p, 32, "%lld", (long long)int_cols[r]);
        // string column (scene_type)
        int32_t si = str_idx[r];
        if (si < 0 || si >= n_names) { std::fclose(f); std::free(iobuf); return -2; }
        *p++ = ',';
        int sn = std::snprintf(p, 64, "%s", str_names[si]);
        p += sn < 63 ? sn : 63;  // snprintf returns the UNtruncated length
        // remaining int columns
        for (int c = 1; c < n_int; ++c) {
            *p++ = ',';
            p += std::snprintf(p, 32, "%lld", (long long)int_cols[(int64_t)c * n_rows + r]);
        }
        // double columns
        for (int c = 0; c < n_dbl; ++c) {
            *p++ = ',';
            p += std::snprintf(p, 48, "%.9g", dbl_cols[(int64_t)c * n_rows + r]);
        }
        *p++ = '\n';
        std::fwrite(row, 1, (size_t)(p - row), f);
    }
    int rc = std::fclose(f);
    std::free(iobuf);
    return rc == 0 ? 0 : -3;
}

}  // extern "C"
